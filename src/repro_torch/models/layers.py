"""Shared neural layers of the port: norms, RoPE, GQA attention, MLP.

Port of ``src/repro/models/layers.py`` for the dense attention kinds
(``global``, ``local``, ``chunk``).  Each layer is an ``nn.Module`` whose
parameters keep the reference's layouts (``wq`` [E, H, Dh], ``wo``
[H * Dh, E], ``wi`` [E, g, F] ...), so weights load one for one.  Storage
dtypes follow what the reference computes with: the projection weights are
cast to ``cfg.dtype`` at every use there, so they are stored in it; norm
scales stay float32.

Full-sequence attention (prefill) goes through the flash-prefill kernel on
CUDA and its plain version on the CPU (``repro_torch.kernels.flash_prefill``),
where the reference computes the same masks inline in jnp
(``layers.flash_attention``).  The reference's ``actsharding`` hooks are the
identity on one device and have no counterpart here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.models import module as init
from repro_torch.models.config import ArchConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


class Maker:
    """Makes parameters: drawn from ``gen`` in the reference's order and
    distributions, or left uninitialised (``gen=None``) for weights that
    are loaded afterwards (``repro_torch.models.convert``)."""

    def __init__(self, gen: torch.Generator | None, device):
        self.gen = gen
        self.device = device

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t, requires_grad=False)

    def dense(self, in_dim, out_dims, *, dtype, scale=None) -> nn.Parameter:
        if self.gen is None:
            out = (out_dims,) if isinstance(out_dims, int) else out_dims
            return self._param(torch.empty((in_dim, *out), dtype=dtype,
                                           device=self.device))
        return self._param(init.dense(self.gen, in_dim, out_dims, dtype=dtype,
                                      scale=scale, device=self.device))

    def embed(self, vocab, dim) -> nn.Parameter:
        if self.gen is None:
            return self._param(torch.empty((vocab, dim), dtype=torch.float32,
                                           device=self.device))
        return self._param(init.embed(self.gen, vocab, dim,
                                      device=self.device))

    def zeros(self, shape, *, dtype=torch.float32) -> nn.Parameter:
        return self._param(init.zeros(shape, dtype=dtype, device=self.device))

    def ones(self, shape, *, dtype=torch.float32) -> nn.Parameter:
        return self._param(init.ones(shape, dtype=dtype, device=self.device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm (``scale``, not ``1 + scale``) or LayerNorm, in float32."""

    def __init__(self, cfg: ArchConfig, mk: Maker):
        super().__init__()
        self.kind = cfg.norm
        self.scale = mk.ones((cfg.d_model,))
        if cfg.norm == "layernorm":
            self.bias = mk.zeros((cfg.d_model,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.kind == "layernorm":
            mu = xf.mean(-1, keepdim=True)
            var = ((xf - mu) ** 2).mean(-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + 1e-5)
            y = y * self.scale + self.bias
        else:
            var = (xf ** 2).mean(-1, keepdim=True)
            y = xf * torch.rsqrt(var + 1e-6) * self.scale
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (full / partial-dim "2d" variant)
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, *, theta: float,
                fraction: float = 1.0):
    """cos / sin [..., S, 1, rot // 2] (float32) for positions [..., S]."""
    rot = int(head_dim * fraction) // 2 * 2
    half = rot // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions[..., None, None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """x [..., S, H, D] rotated by ``rope_tables``; the rotated part is
    computed in float32 (bf16 x float32 promotes) and cast back."""
    cos, sin = tables
    half = cos.shape[-1]
    xr, xp = x[..., :2 * half], x[..., 2 * half:]
    x1, x2 = xr[..., :half], xr[..., half:]
    xr = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([xr.to(x.dtype), xp], -1)


def rope(x, positions, *, theta: float, fraction: float = 1.0):
    """x [..., S, H, D]; positions [..., S] (broadcastable)."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta=theta,
                                     fraction=fraction))


# ---------------------------------------------------------------------------
# Attention block (GQA; global / local / chunk)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: Maker):
        super().__init__()
        E, H, KvH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim_
        dt = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.wq = mk.dense(E, (H, Dh), dtype=dt)
        self.wk = mk.dense(E, (KvH, Dh), dtype=dt)
        self.wv = mk.dense(E, (KvH, Dh), dtype=dt)
        self.wo = mk.dense(H * Dh, E, dtype=dt, scale=1.0 / math.sqrt(H * Dh))
        self.has_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = mk.zeros((H, Dh), dtype=dt)
            self.bk = mk.zeros((KvH, Dh), dtype=dt)
            self.bv = mk.zeros((KvH, Dh), dtype=dt)

    def qkv(self, x: torch.Tensor):
        """Project x [B, S, E] to q [B, S, H, D] and k, v [B, S, KvH, D]."""
        B, S, E = x.shape
        q = (x @ self.wq.view(E, -1)).view(B, S, *self.wq.shape[1:])
        k = (x @ self.wk.view(E, -1)).view(B, S, *self.wk.shape[1:])
        v = (x @ self.wv.view(E, -1)).view(B, S, *self.wv.shape[1:])
        if self.has_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        return q, k, v

    def out(self, o: torch.Tensor) -> torch.Tensor:
        B, S, H, Dh = o.shape
        return o.reshape(B, S, H * Dh) @ self.wo

    def block(self, x: torch.Tensor, kind: str, tables, *,
              plain: bool = False):
        """Full-sequence causal attention (prefill) over x [B, S, E] at
        positions 0..S-1.  Returns (y [B, S, E], k, v), k rotated: the
        cache takes both as they are.  ``plain`` runs the plain version on
        a CUDA tensor too (for parity checks only)."""
        q, k, v = self.qkv(x)
        q = apply_rope(q, tables)
        k = apply_rope(k, tables)
        window = self.cfg.window if kind == "local" else 0
        chunk = self.cfg.window if kind == "chunk" else 0
        attn = fp_ops.flash_prefill_plain if plain else fp_ops.flash_prefill
        o = attn(q, k, v, window=window, chunk_size=chunk, causal=True)
        return self.out(o), k, v


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU / GeGLU, or plain two-matrix)
# ---------------------------------------------------------------------------


def act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: Maker):
        super().__init__()
        E, Fd = cfg.d_model, cfg.d_ff
        dt = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.wi = mk.dense(E, (2 if cfg.gated_mlp else 1, Fd), dtype=dt)
        self.wo = mk.dense(Fd, E, dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        E, g, Fd = self.wi.shape
        h = (x @ self.wi.view(E, g * Fd)).view(*x.shape[:-1], g, Fd)
        if self.cfg.gated_mlp:
            h = act(h[..., 0, :], self.cfg.act) * h[..., 1, :]
        else:
            h = act(h[..., 0, :], self.cfg.act)
        return h @ self.wo
