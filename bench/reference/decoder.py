"""Plain float32 reference of the decoder-only transformers the benchmark
serves (mixtral-8x22b, starcoder2-3b).

Plain ``torch`` operations, no kernels, no cache, no batching: the full
causal forward pass over each sequence, one layer at a time (so that a
model whose weights fill most of the card fits beside its activations),
matrix products in float32 with TF32 off.  It imports nothing of the
program: its sizes come from the configuration file, and its weights from
a callable ``weight(name)`` that the harness fills by drawing each tensor
from the run's seed again (``bench/weights.py``).

The architecture is the one the program serves, which departs from the
published models where the configuration file says so (``served_as``):
RMSNorm or LayerNorm in float32 on the residual, rotary embeddings over the
whole head (halves rotated, base ``rope_theta``), grouped-query attention
(query head h reads key/value head h // (H / KvH)) with a causal mask and a
sliding window of ``sliding_window`` positions, then a gated (SwiGLU) or
plain (GeLU, tanh form) MLP, or a top-k mixture of experts whose float32
router's softmax picks the k largest (the lower expert first on a tie) and
whose gates are renormalised to sum to one; the head is either its own
matrix or the tied embedding scaled by hidden_size ** -0.5.

``fp8=True`` is the control: the same function with every product against
a bf16 weight (the projections, the experts, the head) computed from
float8 e4m3 operands, each weight column and each activation row scaled to
e4m3's range, as an fp8 serving path would.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

#: rows of queries a block of attention scores holds at once
Q_BLOCK = 1024
#: float8 e4m3's largest finite value
E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Arch:
    E: int
    H: int
    KvH: int
    Dh: int
    F: int
    V: int
    L: int
    X: int
    K: int
    theta: float
    window: int
    tied: bool
    act: str
    norm: str
    eps: float
    gated: bool
    qkv_bias: bool
    tied_scale: bool


def arch(cfg: dict) -> Arch:
    """The sizes and choices the reference needs, from a configuration file
    (Hugging Face key names, as run; ``served_as`` for what the keys do not
    say)."""
    served = cfg["served_as"]
    E, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return Arch(
        E=E, H=H, KvH=cfg["num_key_value_heads"],
        Dh=cfg.get("head_dim") or E // H, F=cfg["intermediate_size"],
        V=cfg["vocab_size"], L=cfg["num_hidden_layers"],
        X=cfg.get("num_local_experts", 0),
        K=cfg.get("num_experts_per_tok", 0),
        theta=float(cfg["rope_theta"]), window=cfg.get("sliding_window") or 0,
        tied=bool(cfg["tie_word_embeddings"]),
        act={"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh"}[
            cfg["hidden_act"]],
        norm=served["norm"], eps=float(served["norm_eps"]),
        gated=served["mlp"] == "gated", qkv_bias=served["bias"] == "qkv",
        tied_scale=bool(served.get("tied_logit_scale", False)))


def param_specs(cfg: dict) -> dict[str, tuple[tuple, str, tuple]]:
    """{name: (shape, dtype name, (mean, std))}: every weight of the model,
    with the names and layouts the program's parameters have, the dtype it
    serves each in (the projections, experts and head in ``served_as``'s
    dtype, the rest float32), and the normal distribution the benchmark
    draws it from (``bench/weights.py``): a matrix N(0, 1 / fan-in), the
    embedding N(0, initializer_range) as the model initialises it (an
    embedding as large as the layers' outputs would make a tied head
    predict its input token again at every step), norm scales N(1, 0.1),
    biases N(0, 0.1)."""
    a = arch(cfg)
    E, H, KvH, Dh, Fd, X = a.E, a.H, a.KvH, a.Dh, a.F, a.X
    bf, f32 = cfg["served_as"]["dtype"], "float32"

    def mat(fan_in):
        return (0.0, 1.0 / math.sqrt(fan_in))

    specs: dict[str, tuple] = {
        "embed": ((a.V, E), f32, (0.0, float(cfg["initializer_range"])))}

    def norm(prefix):
        specs[prefix + ".scale"] = ((E,), f32, (1.0, 0.1))
        if a.norm == "layer_norm":
            specs[prefix + ".bias"] = ((E,), f32, (0.0, 0.1))

    for li in range(a.L):
        p = f"blocks.{li}."
        norm(p + "ln1")
        specs[p + "mixer.wq"] = ((E, H, Dh), bf, mat(E))
        specs[p + "mixer.wk"] = ((E, KvH, Dh), bf, mat(E))
        specs[p + "mixer.wv"] = ((E, KvH, Dh), bf, mat(E))
        specs[p + "mixer.wo"] = ((H * Dh, E), bf, mat(H * Dh))
        if a.qkv_bias:
            specs[p + "mixer.bq"] = ((H, Dh), bf, (0.0, 0.1))
            specs[p + "mixer.bk"] = ((KvH, Dh), bf, (0.0, 0.1))
            specs[p + "mixer.bv"] = ((KvH, Dh), bf, (0.0, 0.1))
        norm(p + "ln2")
        if X:
            specs[p + "ffn.router"] = ((E, X), f32, mat(E))
            specs[p + "ffn.wi"] = ((X, E, 2, Fd), bf, mat(E))
            specs[p + "ffn.wo"] = ((X, Fd, E), bf, mat(Fd))
        else:
            specs[p + "ffn.wi"] = ((E, 2 if a.gated else 1, Fd), bf, mat(E))
            specs[p + "ffn.wo"] = ((Fd, E), bf, mat(Fd))
    norm("final_norm")
    if not a.tied:
        specs["lm_head"] = ((E, a.V), bf, mat(E))
    return specs


@contextlib.contextmanager
def _no_tf32():
    mm, cd = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale per slice along ``dim``
    (that slice's largest magnitude maps to e4m3's largest value), back in
    float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x [n, in] @ w [in, out] in float32; under ``fp8`` from e4m3
    operands (a scale per row of x and per column of w)."""
    if fp8:
        x, w = _e4m3(x, -1), _e4m3(w, 0)
    return x @ w


def _norm(a: Arch, x, weight, prefix):
    if a.norm == "layer_norm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + a.eps)
        return y * weight(prefix + ".scale") + weight(prefix + ".bias")
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + a.eps) * weight(prefix + ".scale")


def _act(a: Arch, x):
    return F.silu(x) if a.act == "silu" else F.gelu(x, approximate="tanh")


def _rope(a: Arch, x, pos):
    """x [S, heads, Dh] rotated at positions pos [S]: the first and second
    halves of a head as the real and imaginary parts."""
    half = a.Dh // 2
    freqs = a.theta ** (-torch.arange(half, dtype=torch.float64,
                                      device=x.device) / half)
    ang = (pos.double()[:, None] * freqs)[:, None, :].float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(a: Arch, q, k, v):
    """Causal attention within the window: q [S, H, Dh], k, v
    [S, KvH, Dh] -> [S, H * Dh], in blocks of Q_BLOCK queries."""
    S = q.shape[0]
    G = a.H // a.KvH
    kk = k.permute(1, 2, 0)                       # [KvH, Dh, S]
    vv = v.permute(1, 0, 2)                       # [KvH, S, Dh]
    keys = torch.arange(S, device=q.device)
    out = []
    for s0 in range(0, S, Q_BLOCK):
        qb = q[s0:s0 + Q_BLOCK].reshape(-1, a.KvH, G, a.Dh).permute(1, 2, 0, 3)
        s = torch.matmul(qb, kk[:, None]) * a.Dh ** -0.5   # [KvH, G, n, S]
        qi = torch.arange(s0, s0 + qb.shape[2], device=q.device)[:, None]
        ok = keys[None, :] <= qi
        if a.window:
            ok &= qi - keys[None, :] < a.window
        s = s.masked_fill(~ok, float("-inf"))
        o = torch.matmul(torch.softmax(s, -1), vv[:, None])  # [KvH, G, n, Dh]
        out.append(o.permute(2, 0, 1, 3).reshape(-1, a.H * a.Dh))
    return torch.cat(out)


def _moe(a: Arch, h, weight, p, fp8, probe):
    probs = torch.softmax(h @ weight(p + "router"), -1)        # [T, X]
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = srt.indices[:, :a.K]
    if probe is not None:
        # how near each token's routing came to a tie between its k-th and
        # (k+1)-th experts, the least over the layers so far
        m = srt.values[:, a.K - 1] - srt.values[:, a.K]
        probe["router_margin"] = torch.minimum(
            probe.get("router_margin", m), m)
    gate = probs.gather(-1, idx)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    wi, wo = weight(p + "wi"), weight(p + "wo")
    y = torch.zeros_like(h)
    for e in range(a.X):
        hit = idx == e
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        g = (gate * hit).sum(-1)[rows, None]
        hh = _mm(h[rows], wi[e].reshape(a.E, 2 * a.F), fp8).view(-1, 2, a.F)
        hh = _act(a, hh[:, 0]) * hh[:, 1]
        y.index_add_(0, rows, _mm(hh, wo[e], fp8) * g)
    return y


def _mlp(a: Arch, h, weight, p, fp8):
    wi = weight(p + "wi")
    g = wi.shape[1]
    hh = _mm(h, wi.reshape(a.E, g * a.F), fp8).view(-1, g, a.F)
    hh = _act(a, hh[:, 0]) * hh[:, 1] if a.gated else _act(a, hh[:, 0])
    return _mm(hh, weight(p + "wo"), fp8)


def _layer(a: Arch, li: int, x, lens: list, weight, fp8: bool, probe):
    """Layer ``li`` over the sequences laid end to end in x [T, E] (their
    lengths ``lens``): the token-wise products over all T rows, attention
    within each sequence."""
    p = f"blocks.{li}."
    T = x.shape[0]
    h = _norm(a, x, weight, p + "ln1")
    q = _mm(h, weight(p + "mixer.wq").reshape(a.E, -1), fp8).view(T, a.H, a.Dh)
    k = _mm(h, weight(p + "mixer.wk").reshape(a.E, -1), fp8).view(
        T, a.KvH, a.Dh)
    v = _mm(h, weight(p + "mixer.wv").reshape(a.E, -1), fp8).view(
        T, a.KvH, a.Dh)
    del h
    if a.qkv_bias:
        q = q + weight(p + "mixer.bq")
        k = k + weight(p + "mixer.bk")
        v = v + weight(p + "mixer.bv")
    o, s0 = [], 0
    for n in lens:
        pos = torch.arange(n, device=x.device)
        sl = slice(s0, s0 + n)
        o.append(_attention(a, _rope(a, q[sl], pos), _rope(a, k[sl], pos),
                            v[sl]))
        s0 += n
    del q, k, v
    x = x + _mm(torch.cat(o), weight(p + "mixer.wo"), fp8)
    del o
    h = _norm(a, x, weight, p + "ln2")
    return x + (_moe(a, h, weight, p + "ffn.", fp8, probe) if a.X
                else _mlp(a, h, weight, p + "ffn.", fp8))


@torch.no_grad()
def logits(cfg: dict, weight, seqs: list, positions: list, *,
           fp8: bool = False, probe: dict | None = None) -> list:
    """The logits [len(positions[i]), V] (float32) at ``positions[i]`` of
    each token sequence ``seqs[i]`` (a 1-D int64 tensor on the device the
    weights are on), from the full causal forward pass; ``weight(name)``
    returns that parameter in float32 (called once a name).  A ``probe``
    dict receives ``router_margin`` [T] (a mixture of experts' routing:
    each token's least gap over the layers between the k-th and the
    (k+1)-th expert's probability), rows laid end to end as ``seqs``."""
    a = arch(cfg)
    lens = [int(s.numel()) for s in seqs]
    with _no_tf32():
        x = weight("embed")[torch.cat(seqs)]
        for li in range(a.L):
            x = _layer(a, li, x, lens, weight, fp8, probe)
        starts = [0]
        for n in lens[:-1]:
            starts.append(starts[-1] + n)
        rows = torch.cat([torch.as_tensor(pos, device=x.device) + s0
                          for pos, s0 in zip(positions, starts)])
        h = _norm(a, x[rows], weight, "final_norm")
        del x
        head = weight("embed").t() if a.tied else weight("lm_head")
        y = _mm(h, head, fp8)
        if a.tied and a.tied_scale:
            y = y * a.E ** -0.5
        return list(torch.split(y, [len(p) for p in positions]))
