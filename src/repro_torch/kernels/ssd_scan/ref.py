"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

Port of ``src/repro/kernels/ssd_scan/ref.py``, the oracle of the Pallas
kernel ``kernel.py::_ssd_kernel``.  The discrete-time selective-SSM
recurrence, per batch b and head h (group g = h * G // H):

    S_t = a[t, h] * S_{t-1} + x[t, h, :] (outer) B[t, g, :]    S in R^{P x N}
    y[t, h, :] = S_t @ C[t, g, :]

x [Bsz, L, H, P]; a [Bsz, L, H] decay factors in (0, 1]; B, C
[Bsz, L, G, N].  ``ssd_scan`` walks the tokens one by one in float32, in the
reference's step order, and returns (y [Bsz, L, H, P] in x's dtype, final
state [Bsz, H, P, N] float32): the plain version of both kernels, which
the wrapper runs for a CPU tensor.  ``ssd_scan_chunked`` computes what the
tensor-core kernel computes, in its order and with its bf16 rounding
points, for the tests and ``chip_smoke.py``; the model never calls it.
"""
from __future__ import annotations

import math

import torch

_LOG2E = 1.0 / math.log(2.0)


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


def ssd_scan_chunked(x, a, B, C, chunk: int = 128):
    """What the tensor-core kernel (``csrc/ssd_scan_tc.cu``) computes, in
    its order, as plain torch on any device: the SSD paper's chunked
    decomposition (arXiv:2405.21060, section 6) with its rounding points.
    Same arguments and results as ``ssd_scan``.

    Per chunk of ``chunk`` tokens (the last one padded with the neutral
    a = 1, x = B = C = 0), with ca the prefix sum of log(max(a, 1e-37)) in
    float64:

    1. ``C B^T`` once per (batch, group, chunk), float32; the chunk state
       ``S_c = (x o w)^T B`` with w_j = exp(ca_last - ca_j), and ca itself;
    2. the state pass: ``S_prev[c]`` is the state entering chunk c,
       ``S <- exp(ca_last) S + S_c`` in float32, the final state float32;
    3. ``y = M x + exp(ca_i) C S_prev^T`` with M = (C B^T) o exp(ca_i -
       ca_j) for j <= i (taken only there), else 0.  In log2 units from
       (hi, lo) float pairs of ca / ln 2: where the chunk's decay spans at
       most 2^120, exp(ca_i - ca_j) = e_i f_j with e = 2^(ca - mid) and
       f = 2^(mid - ca) about the middle of the range (every factor within
       2^+-60), M = (C B^T e_i) f_j; otherwise 2^((hi_i - hi_j) + (lo_i -
       lo_j)) an entry, as exact as the float64 difference rounded to
       float32.

    With bf16 x, B and C (the kernel's operands) the computed operands
    ``x o w``, ``M`` and ``S_prev`` are rounded to bf16, as the kernel
    feeds them to the tensor cores; with float32 operands nothing is
    rounded, which checks the decomposition alone.  Every product
    accumulates in float32.  Used by the tests and ``chip_smoke.py`` only.
    """
    y, S, _ = _chunked_forward(x, a, B, C, chunk)
    return y, S


def _chunked_forward(x, a, B, C, chunk: int):
    """``ssd_scan_chunked``'s (y, final state) and the state entering each
    chunk, S_prev [Bsz, nc, H, P, N] float32 (rounded to bf16 with bf16
    operands, as the tensor-core kernel stores it; zero for chunk 0)."""
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    op = torch.bfloat16 if x.dtype == B.dtype == torch.bfloat16 \
        else torch.float32
    nc = -(-L // chunk)
    pad = nc * chunk - L
    hg = _head_group(H, G, x.device)

    def chunks(t, fill=0.0):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_full((Bsz, pad) + t.shape[2:], fill)], 1)
        return t.reshape((Bsz, nc, chunk) + t.shape[2:])

    xc, ac = chunks(x), chunks(a, 1.0)              # [b, c, j, h, (p)]
    Bc, Cc = chunks(B), chunks(C)                   # [b, c, j, g, n]
    ca = torch.log(ac.clamp(min=1e-37).double()).cumsum(2)
    ca_last = ca[:, :, -1]                          # [b, c, h]
    # 1. C B^T per group; the chunk states
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    w = torch.exp(ca_last[:, :, None] - ca).float()
    xw = (xc * w[..., None]).to(op).float()
    s_c = torch.einsum("bcjhp,bcjhn->bchpn", xw, Bc[:, :, :, hg])
    # 2. the state pass
    dA = torch.exp(ca_last).float()
    S = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    s_prev = []
    for c in range(nc):
        s_prev.append(S)
        S = dA[:, c, :, None, None] * S + s_c[:, c]
    if not nc:
        return x.new_zeros(x.shape), S, S.new_zeros((Bsz, 0, H, P, N))
    sp = torch.stack(s_prev, 1).to(op).float()      # [b, c, h, p, n]
    # 3. the outputs
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # the decay in log2 units from float (hi, lo) pairs of ca / ln 2, as
    # the kernel: factored about the middle of the chunk's range where it
    # spans at most 2^120, else one exponential an entry
    ca2 = ca * _LOG2E
    ca_hi = ca2.float()
    ca_lo = (ca2 - ca_hi.double()).float()              # [b, c, i, h]
    mid = 0.5 * (ca_hi[:, :, :1] + ca_hi[:, :, -1:])
    e = torch.exp2((ca_hi - mid) + ca_lo)
    f = torch.exp2((mid - ca_hi) - ca_lo)
    factored = (ca_hi[:, :, 0] - ca_hi[:, :, -1] <= 120.0)[:, :, None, None]
    cbh = cb[:, :, hg].permute(0, 1, 3, 4, 2)           # [b, c, i, j, h]
    m_fac = (cbh * e[:, :, :, None]) * f[:, :, None, :]
    seg = (ca_hi[:, :, :, None] - ca_hi[:, :, None, :]) + \
        (ca_lo[:, :, :, None] - ca_lo[:, :, None, :])
    m_exp = cbh * torch.exp2(seg.masked_fill(~causal, 0.0))
    M = torch.where(causal, torch.where(factored, m_fac, m_exp), 0.0)
    M = M.to(op).float()
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
    y_off = torch.einsum("bcihn,bchpn->bcihp", Cc[:, :, :, hg], sp)
    y = y_off * torch.exp2(ca_hi.double() + ca_lo.double()).float()[
        ..., None] + y
    y = y.reshape(Bsz, nc * chunk, H, P)[:, :L]
    return y.to(x.dtype), S, sp


def slice_bounds(hpg: int, slices: int) -> list[tuple[int, int]]:
    """The heads [h0, h1) of each of ``slices`` slices of a group's ``hpg``
    heads, in the order the tensor-core backward adds their partial sums
    (its head-slice kernel's formula)."""
    return [(s * hpg // slices, (s + 1) * hpg // slices)
            for s in range(slices)]


def ssd_scan_chunked_backward(x, a, B, C, dy, d_state, chunk: int = 128,
                              tensor_core: bool = False, slices: int = 1):
    """What the backward kernels (``csrc/ssd_scan_bwd.cu``; with
    ``tensor_core``, ``csrc/ssd_scan_tc_bwd.cu``) compute, in their order,
    as plain torch on any device: the gradients (dx, da, dB, dC) of
    (y, final state) = ``ssd_scan_chunked(x, a, B, C)`` from the
    cotangents dy [Bsz, L, H, P] and d_state [Bsz, H, P, N] (either may be
    None: zero), each in its input's dtype.

    It reads the state entering each chunk as the forward stores it
    (``_chunked_forward``: bf16 with bf16 operands) and computes in float32
    (ca in float64, as the forward).  With dS the gradient at a chunk's
    end (seeded by d_state), e_i = exp(ca_i), w_j = exp(ca_last - ca_j)
    and D_ij = exp(ca_i - ca_j) for j <= i (else 0):

    1. the chunk-local state gradient ``sum_i e_i dy_i (outer) C_i``;
    2. the reverse pass dS[c] = exp(ca_last[c + 1]) dS[c + 1] + (1.)[c + 1];
    3. per chunk, M = (C B^T) o D:
       dx = M^T dy + w o (B dS^T);
       dC = (sum_h (dy x^T) o D) B + sum_h e o (dy S_prev);
       dB = (sum_h (dy x^T) o D)^T C + sum_h w o (x dS);
       the head sums in ascending head order; sum_h (dy x^T) o D as the
       tensor-core kernel takes it with ``slices`` (``slice_bounds``): a
       float32 sum over each slice's heads, then the slices added in order
       (``slices`` = 1: one sum over the group);
    4. d log a_t directly, as the sum of the terms that carry a_t (no
       pair cancels, so it keeps its relative accuracy where a is small):
       sum_{i >= t > j} (dy_i . x_j) M_ij + sum_{i >= t} e_i dy_i .
       (S_prev C_i) + sum_{j < t} w_j x_j . (dS B_j) + exp(ca_last)
       <dS, S_prev>; da = d log a / a where a >= 1e-37, and 0 below the
       forward's clamp (the forward is constant in a there).

    With ``tensor_core`` (bf16 operands) the operands computed for the
    tensor cores are rounded to bf16 where they enter a product, as the
    tensor-core kernels feed them: e o dy, dS, M (in M^T dy), the head sum
    of (dy x^T) o D and w o x; every product still accumulates in float32,
    and d log a's terms take M unrounded.  Without it nothing computed is
    rounded.  Used by the tests, ``rehearse.py`` and ``chip_smoke.py``
    only.
    """
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    dev = x.device
    _, _, sp = _chunked_forward(x, a, B, C, chunk)
    nc = sp.shape[1]
    if dy is None:
        dy = torch.zeros((Bsz, L, H, P), dtype=torch.float32, device=dev)
    if d_state is None:
        d_state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
    if not nc:
        return (torch.zeros_like(x), torch.zeros_like(a),
                torch.zeros_like(B), torch.zeros_like(C))
    pad = nc * chunk - L
    hg = _head_group(H, G, dev)

    def rnd(t):
        return t.to(torch.bfloat16).float() if tensor_core else t

    def chunks(t, fill=0.0):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_full((Bsz, pad) + t.shape[2:], fill)], 1)
        return t.reshape((Bsz, nc, chunk) + t.shape[2:])

    xc, dyc, ac = chunks(x), chunks(dy), chunks(a, 1.0)   # [b, c, i, h, .]
    Bc, Cc = chunks(B), chunks(C)                         # [b, c, i, g, n]
    Bh, Ch = Bc[:, :, :, hg], Cc[:, :, :, hg]
    ca = torch.log(ac.clamp(min=1e-37).double()).cumsum(2)
    ca_last = ca[:, :, -1]                                # [b, c, h]
    e = torch.exp(ca).float()
    w = torch.exp(ca_last[:, :, None] - ca).float()
    dA = torch.exp(ca_last).float()
    # 1. chunk-local state gradients; 2. the reverse pass
    dsc = torch.einsum("bcihp,bcihn->bchpn", rnd(dyc * e[..., None]), Ch)
    D = d_state.float()
    ds = [None] * nc
    for c in reversed(range(nc)):
        ds[c] = D
        D = dA[:, c, :, None, None] * D + dsc[:, c]
    ds = rnd(torch.stack(ds, 1))                          # [b, c, h, p, n]
    # 3. per chunk
    ii = torch.arange(chunk, device=dev)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    seg = (ca[:, :, :, None] - ca[:, :, None, :]).masked_fill(~causal, 0.0)
    Dm = torch.where(causal, torch.exp(seg.float()), 0.0)  # [b, c, i, j, h]
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    M = cb[:, :, hg].permute(0, 1, 3, 4, 2) * Dm
    bds = torch.einsum("bcjhn,bchpn->bcjhp", Bh, ds)
    dx = torch.einsum("bcijh,bcihp->bcjhp", rnd(M), dyc) + w[..., None] * bds
    dyx = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    hsum = (lambda t: t.reshape(t.shape[:-1] + (G, H // G)).sum(-1))

    def slice_sum(t):
        t = t.reshape(t.shape[:-1] + (G, H // G))
        parts = [t[..., lo:hi].sum(-1)
                 for lo, hi in slice_bounds(H // G, slices)]
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out

    dcb = rnd(slice_sum(dyx * Dm))                        # [b, c, i, j, g]
    dC = torch.einsum("bcijg,bcjgn->bcign", dcb, Bc) + hsum(torch.einsum(
        "bcihp,bchpn->bcinh", rnd(dyc * e[..., None]), sp)).transpose(3, 4)
    dB = torch.einsum("bcijg,bcign->bcjgn", dcb, Cc) + hsum(torch.einsum(
        "bcjhp,bchpn->bcjnh", rnd(xc * w[..., None]), ds)).transpose(3, 4)
    # 4. d log a: sum_{i >= t} sum_{j < t} G_ij as an exclusive prefix sum
    # over j, then a sum over i >= t; the other terms as prefix and suffix
    # sums
    Gm = dyx * M
    pre = torch.cat([torch.zeros_like(Gm[:, :, :, :1]),
                     Gm.cumsum(3)[:, :, :, :-1]], 3)      # [b, c, i, t, h]
    R = torch.where(causal, pre, 0.0).sum(2)              # [b, c, t, h]
    cs = torch.einsum("bcihn,bchpn->bcihp", Ch, sp)
    u = e * (dyc * cs).sum(-1)
    v = w * (xc * bds).sum(-1)
    z = dA * (ds * sp).sum((-1, -2))
    U = u.flip(2).cumsum(2).flip(2)
    V = torch.cat([torch.zeros_like(v[:, :, :1]), v.cumsum(2)[:, :, :-1]], 2)
    dla = R + U + V + z[:, :, None]
    da = torch.where(ac >= 1e-37, dla / ac, 0.0)

    def unchunk(t, like):
        return t.reshape((Bsz, nc * chunk) + t.shape[3:])[:, :L].to(like.dtype)

    return (unchunk(dx, x), unchunk(da, a), unchunk(dB, B), unchunk(dC, C))
