"""Shared neural layers of the port: norms, RoPE, GQA attention, MLP, the
top-k MoE feed-forward, the RG-LRU recurrent block and the Mamba2 SSD
block.

Port of ``src/repro/models/layers.py`` for the dense attention kinds
(``global``, ``local``, ``chunk``), the bidirectional ``encoder`` and the
``cross`` kind (``Attention.block``), the ``rglru`` and ``ssd`` kinds and
MoE layers.  Each layer is an ``nn.Module`` whose parameters keep the
reference's names and layouts (``wq`` [E, H, Dh], ``wo`` [H * Dh, E],
``wi`` [E, g, F], the MoE's ``wi`` [X, E, 2, F], ``in_proj``
[E, 2 Din + 2 G N + H] ...), so weights load one for one.  Two storage
modes (``Maker(train=...)``):

* serving: dtypes follow what the reference computes with.  The
  projection weights are cast to ``cfg.dtype`` at every use there, so they
  are stored in it; norm scales, the MoE router, the RG-LRU gates (``wa``,
  ``wi``, used in float32) and the conv taps, decay and skip parameters
  stay float32.  No parameter requires grad.
* training: every parameter is float32 and requires grad, as the
  reference's parameters are float32 leaves of its gradient.

Every use casts a weight to the activations' dtype (``.to(x.dtype)``, a
no-op on serving storage), so both modes compute the reference's values
and, in training, gradients reach the float32 leaves through the casts.

Full-sequence attention (prefill) goes through the flash-prefill kernel on
CUDA and its plain version on the CPU (``repro_torch.kernels.flash_prefill``;
with grad enabled, ``flash_attention``: the same kernel and its backward
kernel),
where the reference computes the same masks inline in jnp
(``layers.flash_attention``): causal for the decoder kinds, none
(``causal=False``) for the encoder and for cross-attention, whose Sk is the
memory's length.  The Mamba2 prefill goes through the SSD-scan
kernel on CUDA (``repro_torch.kernels.ssd_scan``), where the reference
calls its sequential oracle ``ssd_ref.ssd_scan``.  The RG-LRU scan and
the MoE dispatch have no kernel in the reference either (an
``associative_scan`` in jnp and XLA's ``ragged_dot``): the port mirrors
them in torch ops.  ``MoE.capacity`` is the reference's training dispatch
(``dropless=False``: capacity-bounded, overflow dropped) and
``moe_aux_loss`` its load-balance loss.  ``MLP`` calls the activation-
sharding hooks where the reference's ``mlp_block`` does
(``repro_torch.distributed.actsharding``: the identity unless enabled).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import actsharding, fsdp
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref
from repro_torch.models import module as init
from repro_torch.models.config import ArchConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


class Maker:
    """Makes parameters: drawn from ``gen`` in the reference's order and
    distributions, or left uninitialised (``gen=None``) for weights that
    are loaded afterwards (``repro_torch.models.convert``) or for shapes
    alone (``device="meta"``: nothing is allocated).  ``train`` makes every
    parameter float32 and requiring grad (the training storage, module
    docstring).  Each parameter comes with its logical axes, one name a
    dimension (``"embed"``, ``"heads"``, ``"mlp"``, ...), as the
    reference's ``nn.ParamCollector`` records them; ``axes`` maps each
    parameter's ``id`` to its tuple (``repro_torch.distributed.sharding``
    resolves them to mesh axes)."""

    def __init__(self, gen: torch.Generator | None, device, *,
                 train: bool = False):
        self.gen = gen
        self.device = device
        self.train = train
        self.axes: dict[int, tuple] = {}

    def _param(self, t: torch.Tensor, axes: tuple) -> nn.Parameter:
        if len(axes) != t.ndim:
            raise ValueError(f"axes {axes} do not name the {t.ndim} "
                             f"dimensions of {list(t.shape)}")
        p = nn.Parameter(t, requires_grad=self.train)
        self.axes[id(p)] = tuple(axes)
        return p

    def dense(self, in_dim, out_dims, axes: tuple, *, dtype,
              scale=None) -> nn.Parameter:
        if self.train:
            dtype = torch.float32
        if self.gen is None:
            out = (out_dims,) if isinstance(out_dims, int) else out_dims
            return self._param(torch.empty((in_dim, *out), dtype=dtype,
                                           device=self.device), axes)
        return self._param(init.dense(self.gen, in_dim, out_dims, dtype=dtype,
                                      scale=scale, device=self.device), axes)

    def embed(self, vocab, dim) -> nn.Parameter:
        axes = ("vocab", "embed")
        if self.gen is None:
            return self._param(torch.empty((vocab, dim), dtype=torch.float32,
                                           device=self.device), axes)
        return self._param(init.embed(self.gen, vocab, dim,
                                      device=self.device), axes)

    def zeros(self, shape, axes: tuple, *,
              dtype=torch.float32) -> nn.Parameter:
        dtype = torch.float32 if self.train else dtype
        return self._param(init.zeros(shape, dtype=dtype, device=self.device),
                           axes)

    def ones(self, shape, axes: tuple, *,
             dtype=torch.float32) -> nn.Parameter:
        return self._param(init.ones(shape, dtype=dtype, device=self.device),
                           axes)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm (``scale``, not ``1 + scale``) or LayerNorm, in float32."""

    def __init__(self, cfg: ArchConfig, mk: Maker):
        super().__init__()
        self.kind = cfg.norm
        self.scale = mk.ones((cfg.d_model,), ("embed",))
        if cfg.norm == "layernorm":
            self.bias = mk.zeros((cfg.d_model,), ("embed",))

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
    # torch.full (a fill on the device), not torch.tensor (a host copy): a
    # CUDA graph of the decode step captures this
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
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
# Attention block (GQA; global / local / chunk / encoder / cross)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: Maker):
        super().__init__()
        E, H, KvH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim_
        dt = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.wq = mk.dense(E, (H, Dh), ("embed", "heads", "head_dim"),
                           dtype=dt)
        self.wk = mk.dense(E, (KvH, Dh), ("embed", "kv_heads", "head_dim"),
                           dtype=dt)
        self.wv = mk.dense(E, (KvH, Dh), ("embed", "kv_heads", "head_dim"),
                           dtype=dt)
        self.wo = mk.dense(H * Dh, E, ("heads_flat", "embed"), dtype=dt,
                           scale=1.0 / math.sqrt(H * Dh))
        self.has_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = mk.zeros((H, Dh), ("heads", "head_dim"), dtype=dt)
            self.bk = mk.zeros((KvH, Dh), ("kv_heads", "head_dim"), dtype=dt)
            self.bv = mk.zeros((KvH, Dh), ("kv_heads", "head_dim"), dtype=dt)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """Project x [B, S, E] to q [B, S, H, D] alone (a cross or
        encoder-decoder layer's decode: its K/V are the memory's)."""
        B, S, E = x.shape
        dt = x.dtype
        q = (x @ self.wq.to(dt).view(E, -1)).view(B, S, *self.wq.shape[1:])
        return q + self.bq.to(dt) if self.has_bias else q

    def kv(self, src: torch.Tensor):
        """Project a memory src [B, F, E] to k, v [B, F, KvH, D]."""
        B, F_, E = src.shape
        dt = src.dtype
        k = (src @ self.wk.to(dt).view(E, -1)).view(B, F_,
                                                    *self.wk.shape[1:])
        v = (src @ self.wv.to(dt).view(E, -1)).view(B, F_,
                                                    *self.wv.shape[1:])
        if self.has_bias:
            k, v = k + self.bk.to(dt), v + self.bv.to(dt)
        return k, v

    def qkv(self, x: torch.Tensor):
        """Project x [B, S, E] to q [B, S, H, D] and k, v [B, S, KvH, D]."""
        return (self.q(x), *self.kv(x))

    def out(self, o: torch.Tensor) -> torch.Tensor:
        B, S, H, Dh = o.shape
        return o.reshape(B, S, H * Dh) @ self.wo.to(o.dtype)

    def block(self, x: torch.Tensor, kind: str, tables, *,
              memory: torch.Tensor | None = None, plain: bool = False):
        """Full-sequence attention (prefill) over x [B, S, E]: causal at
        positions 0..S-1 for the decoder kinds (``global``, ``local``,
        ``chunk``); ``encoder``, bidirectional with RoPE at 0..S-1
        (``tables``); ``cross``, q from x against K/V of ``memory``
        [B, F, E], without RoPE or mask (Sq = S, Sk = F).  Returns
        (y [B, S, E], k, v): k rotated for the decoder kinds, the memory's
        K/V unrotated for ``cross``; a cache takes both as they are.
        ``plain`` runs the plain version on a CUDA tensor too (for parity
        checks only).  With grad enabled (training) the attention is
        ``flash_attention``, whose backward is a kernel too."""
        if torch.is_grad_enabled():
            def attn(q, k, v, **kw):
                return fp_ops.flash_attention(q, k, v, plain=plain, **kw)
        else:
            attn = fp_ops.flash_prefill_plain if plain \
                else fp_ops.flash_prefill
        if kind == "cross":
            # no RoPE across modalities, as the reference
            k, v = self.kv(memory)
            o = attn(self.q(x), k, v, causal=False)
            return self.out(o), k, v
        q, k, v = self.qkv(x)
        q = apply_rope(q, tables)
        k = apply_rope(k, tables)
        if kind == "encoder":
            o = attn(q, k, v, causal=False)
        else:
            window = self.cfg.window if kind == "local" else 0
            chunk = self.cfg.window if kind == "chunk" else 0
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
        self.wi = mk.dense(E, (2 if cfg.gated_mlp else 1, Fd),
                           ("embed", "gate", "mlp"), dtype=dt)
        self.wo = mk.dense(Fd, E, ("mlp", "embed"), dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``mlp_block``, with its activation-sharding
        hooks (``repro_torch.distributed.actsharding``: the identity unless
        enabled) at the same places."""
        E, g, Fd = self.wi.shape
        dt = x.dtype
        wi = actsharding.gathered_weight(self.wi.to(dt), model_dim=-1)
        wo = actsharding.gathered_weight(self.wo.to(dt), model_dim=0)
        h = (x @ wi.reshape(E, g * Fd)).view(*x.shape[:-1], g, Fd)
        h = actsharding.constrain_hidden(h)
        if self.cfg.gated_mlp:
            h = act(h[..., 0, :], self.cfg.act) * h[..., 1, :]
        else:
            h = act(h[..., 0, :], self.cfg.act)
        return h @ wo


# ---------------------------------------------------------------------------
# MoE (token-choice top-k router; exact dispatch)
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """The reference's ``moe_block`` in its serving form (``dropless=True``)
    with its parameters (``init_moe``): ``router`` [E, X] float32, ``wi``
    [X, E, 2, F] and ``wo`` [X, F, E] in ``cfg.dtype``.  Two dispatch forms
    of the same function, chosen by the caller:

    * ``grouped`` (prefill, eager): the routed (token, expert) pairs sorted
      stably by expert, the group sizes read to the host once, and each
      expert's contiguous rows through its own matmuls: what ``ragged_dot``
      computes, with work in proportion to the routed rows;
    * ``all_experts`` (decode, inside the CUDA graph): no host read and
      fixed shapes; every expert runs every token, and a token keeps only
      the outputs of the experts it was routed to (``torch.where``).  A
      token routes to an expert at most once, so this is exact dispatch
      too.

    Both sum a token's gated outputs in float32 in ascending expert order,
    the order of the reference's ``segment_sum`` over expert-sorted rows,
    and cast the sum to the activations' dtype once."""

    def __init__(self, cfg: ArchConfig, mk: Maker):
        super().__init__()
        E, Fd, X = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.router = mk.dense(E, X, ("embed", "experts"), dtype=torch.float32)
        self.wi = mk.dense(X, (E, 2, Fd),
                           ("experts", "embed", "gate", "expert_mlp"),
                           dtype=dt)
        self.wo = mk.dense(X, (Fd, E), ("experts", "expert_mlp", "embed"),
                           dtype=dt)

    def route(self, xt: torch.Tensor, idx: torch.Tensor | None = None):
        """Gates [T, K] float32 (normalised to sum 1) and expert indices
        [T, K] of tokens xt [T, E]: the float32 router's softmax, its top k
        in ``lax.top_k``'s order (larger first, the lower expert first on a
        tie: a stable descending sort).  A given ``idx`` pins the experts
        and takes their gates from this call's softmax (a parity check runs
        the plain versions on the routing of the kernels' run)."""
        probs = torch.softmax(xt.float() @ self.router, -1)
        if idx is None:
            idx = torch.sort(probs, stable=True, dim=-1,
                             descending=True).indices[:, :self.cfg.top_k]
        gate = probs.gather(-1, idx)
        return gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9), idx

    def _expert(self, e: int, xs: torch.Tensor) -> torch.Tensor:
        """Expert ``e``'s gated MLP on rows xs [n, E] -> [n, E]."""
        E, _, Fd = self.wi.shape[1:]
        dt = xs.dtype
        h = (xs @ self.wi[e].to(dt).view(E, 2 * Fd)).view(-1, 2, Fd)
        h = act(h[:, 0], self.cfg.act) * h[:, 1] if self.cfg.gated_mlp \
            else act(h[:, 0], self.cfg.act)
        return h @ self.wo[e].to(dt)

    def grouped(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, E] through the dropless dispatch (one host read)."""
        B, S, E = x.shape
        xt = x.reshape(B * S, E)
        gate, idx = self.route(xt)
        flat = idx.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        counts = torch.bincount(flat, minlength=self.cfg.n_experts).tolist()
        src = order // self.cfg.top_k
        g = gate.reshape(-1)[order]
        y = torch.zeros((B * S, E), dtype=torch.float32, device=x.device)
        start = 0
        for e, n in enumerate(counts):
            if n:
                rows = src[start:start + n]
                # a token appears once in an expert's rows: no add collides
                y.index_add_(0, rows, self._expert(e, xt[rows])
                             * g[start:start + n, None])
            start += n
        return y.to(x.dtype).view(B, S, E)

    def capacity(self, x: torch.Tensor, split=None):
        """x [B, S, E] through the reference's training dispatch
        (``moe_block(dropless=False)``): capacity C = int(capacity_factor
        T K / X) + 1 rows an expert; the routed (token, expert) pairs sorted
        stably by expert, each expert's first C kept and the rest sent to
        the dump slot X C and dropped; every expert's gated MLP over its
        [C, E] buffer (the gated form always, as the reference); each
        token's kept outputs times its gates summed in float32 in expert
        order (``segment_sum``) and cast once.  Returns (y [B, S, E],
        probs [T, X] float32, the router's softmax for ``moe_aux_loss``).

        With the batch's rows split over ranks (``split``, a
        ``distributed.fsdp.Split`` of more than one rank) the dispatch is
        the global batch's, as the reference's: x's rows of every rank are
        gathered (differentiably), T, C, the drops and probs are the
        global ones, and y is this rank's rows."""
        if split is not None and split.n > 1:
            y, probs = self.capacity(fsdp.gather_rows(x, split))
            return fsdp.own_rows(y, split), probs
        B, S, E = x.shape
        X, K = self.cfg.n_experts, self.cfg.top_k
        T = B * S
        xt = x.reshape(T, E)
        probs = torch.softmax(xt.float() @ self.router, -1)
        gate, idx = self.route(xt)
        flat = idx.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        sorted_e = flat[order]
        counts = torch.bincount(flat, minlength=X)
        src = order // K
        C = int(self.cfg.capacity_factor * T * K / X) + 1
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(T * K, device=x.device) - starts[sorted_e]
        keep = pos < C
        slot = torch.where(keep, sorted_e * C + pos, X * C)
        # the dump row X C takes every dropped pair and is cut off
        buf = xt.new_zeros((X * C + 1, E)).index_copy(0, slot, xt[src])
        dt = xt.dtype
        h = torch.einsum("xce,xegf->xcgf", buf[:-1].view(X, C, E),
                         self.wi.to(dt))
        h = act(h[..., 0, :], self.cfg.act) * h[..., 1, :]
        out = torch.einsum("xcf,xfe->xce", h, self.wo.to(dt))
        routed = torch.where(keep[:, None], out.reshape(X * C, E)[
            torch.clamp(slot, max=X * C - 1)], 0.0)
        g = gate.reshape(-1)[order]
        y = torch.zeros((T, E), dtype=torch.float32, device=x.device) \
            .index_add(0, src, routed * g[:, None])
        return y.to(x.dtype).view(B, S, E), probs

    def all_experts(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, E] through the fixed-shape dispatch (no host read)."""
        B, S, E = x.shape
        xt = x.reshape(B * S, E)
        gate, idx = self.route(xt)
        zero = gate.new_zeros(())
        y = torch.zeros((B * S, E), dtype=torch.float32, device=x.device)
        for e in range(self.cfg.n_experts):
            hit = idx == e
            g = torch.where(hit, gate, zero).sum(-1, keepdim=True)
            y = torch.where(hit.any(-1, keepdim=True),
                            y + self._expert(e, xt) * g, y)
        return y.to(x.dtype).view(B, S, E)


def moe_aux_loss(probs: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss of the router's softmax probs [T, X]
    (the reference's ``moe_aux_loss``): X * sum of the squared mean
    probabilities."""
    me = probs.mean(0)
    return (me * me * probs.shape[-1]).sum()


# ---------------------------------------------------------------------------
# Activations and the causal conv of the recurrent blocks
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: x * (1 / (1 + exp(-x))), each
    step in x's dtype (in bf16 every step rounds to bf16; ``torch.sigmoid``
    rounds once, and differs on many bf16 inputs)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), with no threshold (unlike ``F.softplus``)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv of the reference's ``_causal_conv1d``: x
    [B, S, W]; w [K, W]; b [W]; optional state [B, K-1, W] (the previous
    K-1 inputs).  The taps are summed in the reference's order,
    ``sum(xp[:, i:i+S] * w[i]) + b``, in the promoted type of x and w (a
    float32 sum for bf16 x under float32 taps), then cast to x's dtype; no
    ``F.conv1d``, whose float32 form runs in TF32 on the card.  Returns
    (out [B, S, W], new state = the last K-1 inputs, before any
    activation)."""
    K, S = w.shape[0], x.shape[1]
    pad = x.new_zeros((x.shape[0], K - 1, x.shape[2])) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], 1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return (out + b).to(x.dtype), xp[:, -(K - 1):]


def conv_taps(conv_w: torch.Tensor, conv_b: torch.Tensor, dt: torch.dtype):
    """The reference's ``conv_w.astype(dt) + _conv_id(p)`` and
    ``conv_b.astype(dt)``: ``dt``-rounded taps plus an exact 1.0 at the last
    tap, in float32 (bf16 + float32 promotes), so a zero-initialised conv
    passes its input; the bias cast to ``dt``."""
    w = conv_w.to(dt).to(torch.float32, copy=True)
    w[-1] += 1.0
    return w, conv_b.to(dt)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427)
# ---------------------------------------------------------------------------


def _combine(al, bl, ar, br):
    """The RG-LRU scan's associative step: (al ar, bl ar + br)."""
    return al * ar, bl * ar + br


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """``jax.lax.associative_scan(combine, (a, b), axis=1)`` with its
    recursion, so that values combine in the reference's order: combine
    adjacent pairs, scan those, then combine each odd result with the next
    even element; about 2 log2(S) levels of a few ops, not S steps."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _associative_scan(*_combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                                      a[:, 1::2], b[:, 1::2]))
    head = [o[:, :-1] for o in odd] if n % 2 == 0 else odd
    even = _combine(*head, a[:, 2::2], b[:, 2::2])
    out = []
    for x, ev, od in zip((a, b), even, odd):
        y = torch.empty_like(x)
        y[:, :1] = x[:, :1]
        y[:, 2::2] = ev
        y[:, 1::2] = od
        out.append(y)
    return out


def rglru_scan(a: torch.Tensor, gx: torch.Tensor,
               h0: torch.Tensor | None = None):
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) gx_t over a, gx [B, S, W]
    (float32) from h0 [B, W] (zero when None): the reference's
    ``rglru_scan``.  Returns (h [B, S, W], h [:, -1])."""
    b = torch.sqrt(torch.clamp_min(1.0 - a ** 2, 1e-9)) * gx
    af, bf = _associative_scan(a, b)
    h = bf if h0 is None else bf + af * h0[:, None, :]
    return h, h[:, -1]


class RGLRU(nn.Module):
    """The reference's ``rglru_block`` (Griffin's recurrent block) with its
    parameters (``init_rglru``): a gelu gate branch, an input branch through
    a width-4 causal conv, float32 recurrence and input gates, the RG-LRU
    scan and the out-projection.  ``prefill`` scans the whole prompt from a
    zero state (the reference passes no state); ``decode`` steps the
    recurrence once.  Both write the (conv [B, 3, W], h [B, W] float32)
    cache in place."""

    CONV = 4

    def __init__(self, cfg: ArchConfig, mk: Maker):
        super().__init__()
        E = cfg.d_model
        W = cfg.lru_width or E
        dt = torch_dtype(cfg.dtype)
        self.wx = mk.dense(E, W, ("embed", "mlp"), dtype=dt)
        self.wy = mk.dense(E, W, ("embed", "mlp"), dtype=dt)
        self.conv_w = mk.zeros((self.CONV, W), ("conv", "mlp"))
        self.conv_b = mk.zeros((W,), ("mlp",))
        self.wa = mk.dense(W, W, ("mlp", "mlp2"), dtype=torch.float32)
        self.ba = mk.zeros((W,), ("mlp",))
        self.wi = mk.dense(W, W, ("mlp", "mlp2"), dtype=torch.float32)
        self.bi = mk.zeros((W,), ("mlp",))
        self.lam = mk.ones((W,), ("mlp",))
        self.wo = mk.dense(W, E, ("mlp", "embed"), dtype=dt)

    def _mix(self, x, conv_state, h0):
        """The block on x [B, S, E] from (conv_state, h0), or from zeros
        when both are None.  Returns (out, new conv state, last h)."""
        dt = x.dtype
        gate = act(x @ self.wy.to(dt), "gelu")
        w, b = conv_taps(self.conv_w, self.conv_b, dt)
        u, new_conv = causal_conv1d(x @ self.wx.to(dt), w, b, conv_state)
        uf = u.float()
        r = torch.sigmoid(uf @ self.wa + self.ba)
        i = torch.sigmoid(uf @ self.wi + self.bi)
        a = torch.exp(-8.0 * r * softplus(self.lam))   # c = 8 (the paper)
        h, h_last = rglru_scan(a, i * uf, h0)
        return (h.to(dt) * gate) @ self.wo.to(dt), new_conv, h_last

    def forward(self, x, *, plain: bool = False):
        """Whole sequence x [B, S, E] from a zero state, no cache (training;
        ``plain`` as in ``prefill``)."""
        return self._mix(x, None, None)[0]

    def prefill(self, x, cache, *, plain: bool = False):
        """Whole prompt x [B, S, E] from a zero state into ``cache`` =
        (conv, h).  ``plain`` is accepted for the ``Block`` interface: the
        block launches no kernel."""
        conv, h = cache
        out, new_conv, h_last = self._mix(x, None, None)
        conv.copy_(new_conv)
        h.copy_(h_last)
        return out

    def decode(self, x, cache):
        """One token x [B, 1, E] against ``cache``, updated in place."""
        conv, h = cache
        out, new_conv, h_last = self._mix(x, conv, h)
        conv.copy_(new_conv)
        h.copy_(h_last)
        return out


# ---------------------------------------------------------------------------
# Mamba2 SSD block (arXiv:2405.21060)
# ---------------------------------------------------------------------------


def mamba2_split(cfg: ArchConfig):
    """(Din, H, G, N) of the reference's ``mamba2_split``."""
    Din = cfg.d_inner_mult * cfg.d_model
    return Din, Din // cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state


class Mamba2(nn.Module):
    """The reference's ``mamba2_block`` with its parameters (``init_mamba2``):
    in-projection to (z, x B C, dt), causal conv, SiLU, the SSD scan, the
    skip term, a gated RMSNorm and the out-projection.  ``prefill`` runs the
    scan through the SSD-scan kernel; ``decode`` steps the recurrence once
    in plain torch, as the reference's ``ssd_decode_step`` is plain jnp.
    Both write the (conv, state) cache in place."""

    def __init__(self, cfg: ArchConfig, mk: Maker):
        super().__init__()
        E = cfg.d_model
        Din, H, G, N = mamba2_split(cfg)
        dt = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.in_proj = mk.dense(E, 2 * Din + 2 * G * N + H, ("embed", "mlp"),
                                dtype=dt)
        self.conv_w = mk.zeros((cfg.conv_kernel, Din + 2 * G * N),
                               ("conv", "mlp"))
        self.conv_b = mk.zeros((Din + 2 * G * N,), ("mlp",))
        self.a_log = mk.zeros((H,), ("heads",))
        self.dt_bias = mk.zeros((H,), ("heads",))
        self.d_skip = mk.ones((H,), ("heads",))
        self.norm_scale = mk.ones((Din,), ("mlp",))
        self.out_proj = mk.dense(Din, E, ("mlp", "embed"), dtype=dt)

    def _mix(self, x, conv_state, ssd_state, *, plain: bool = False):
        """The block on x [B, S, E]; the decode form when S == 1 and a state
        is given (``plain`` runs the scan's plain version on a CUDA tensor
        too).  Returns (out, new conv state, new SSD state)."""
        dt_ = x.dtype
        Bsz, S, _ = x.shape
        Din, H, G, N = mamba2_split(self.cfg)
        P = self.cfg.ssm_head_dim
        zxbcdt = x @ self.in_proj.to(dt_)
        z, xbc, dt = torch.split(zxbcdt, [Din, Din + 2 * G * N, H], -1)
        w, b = conv_taps(self.conv_w, self.conv_b, dt_)
        xbc, new_conv = causal_conv1d(xbc, w, b, conv_state)
        xbc = silu(xbc)
        xs, Bc, Cc = torch.split(xbc, [Din, G * N, G * N], -1)
        xs = xs.reshape(Bsz, S, H, P)
        Bc = Bc.reshape(Bsz, S, G, N)
        Cc = Cc.reshape(Bsz, S, G, N)
        dt = softplus(dt.float() + self.dt_bias)              # [B, S, H]
        a = torch.exp(-dt * torch.exp(self.a_log))
        x_in = xs * dt[..., None].to(dt_)
        if S == 1 and ssd_state is not None:
            new_ssd, y = ssd_ref.ssd_decode_step(
                ssd_state, x_in[:, 0].float(), a[:, 0], Bc[:, 0].float(),
                Cc[:, 0].float())
            y = y[:, None]
        elif ssd_ops.needs_grad(x_in, a, Bc, Cc):
            # training: the scan with a gradient (on the card the forward
            # and backward kernels; on the CPU or with ``plain`` the plain
            # scan's torch ops)
            y, new_ssd = ssd_ops.ssd_scan_grad(
                x_in.contiguous(), a.contiguous(), Bc.contiguous(),
                Cc.contiguous(), plain=plain)
        else:
            scan = ssd_ops.ssd_scan_plain if plain else ssd_ops.ssd_scan
            y, new_ssd = scan(x_in.contiguous(), a.contiguous(),
                              Bc.contiguous(), Cc.contiguous())
        skip = (xs * self.d_skip[:, None].to(dt_)).reshape(Bsz, S, Din)
        # the reference adds y and the skip term in bf16 and converts the
        # sum to float32 for the norm; compiled, XLA drops that bf16 round
        # trip (excess precision allowed), so the sum enters unrounded
        yf = y.reshape(Bsz, S, Din).to(dt_).float() + skip.float()
        # gated RMSNorm (float32, eps 1e-6, scale not 1 + scale), then out
        yf = yf * silu(z.float())
        yf = yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + 1e-6)
        y = (yf * self.norm_scale).to(dt_)
        return y @ self.out_proj.to(dt_), new_conv, new_ssd

    def forward(self, x, *, plain: bool = False):
        """Whole sequence x [B, S, E] from a zero state, no cache (training).
        Where autograd needs the output the scan is ``ssd_ops.ssd_scan_grad``:
        on CUDA the SSD-scan kernel writing each chunk's entering state and
        the backward kernel (``SSDScan``); on the CPU, or with ``plain``, the
        plain scan's torch ops."""
        return self._mix(x, None, None, plain=plain)[0]

    def prefill(self, x, cache, *, plain: bool = False):
        """Whole prompt x [B, S, E] from a zero state; writes the prompt's
        last K-1 conv inputs and the final SSD state into ``cache`` =
        (conv [B, K-1, C], state [B, H, P, N])."""
        conv, state = cache
        out, new_conv, new_ssd = self._mix(x, None, None, plain=plain)
        conv.copy_(new_conv)
        state.copy_(new_ssd)
        return out

    def decode(self, x, cache):
        """One token x [B, 1, E] against ``cache``, updated in place."""
        conv, state = cache
        out, new_conv, new_ssd = self._mix(x, conv, state)
        conv.copy_(new_conv)
        state.copy_(new_ssd)
        return out
