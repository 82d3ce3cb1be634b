"""The yardstick's arithmetic: the card's peaks, model FLOPs, and each
kernel's operations and bytes, all from shapes.

Model FLOPs count what the model needs, not what the program executes:
2 FLOPs a parameter a token for the layers' matrices (a mixture of
experts' top-k experts and its router, not all of its experts), the head
for every token whose logits are taken (a prefill's last, each decoded
one), and attention's two products over the keys a query reaches (causal,
within the window).  A kernel's bound counts each input byte read once and
each output byte written once, as PERF.md's kernel table does.
"""
from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet, one card: dense bf16 tensor-core FLOP/s
#: and HBM3 bytes/s (at the 700 W power limit)
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES = 3.35e12

BYTES = {"float32": 4, "bfloat16": 2}


def sizes(cfg: dict) -> dict:
    """The sizes the counts need, from a configuration file."""
    E, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(E=E, H=H, KvH=cfg["num_key_value_heads"],
                Dh=cfg.get("head_dim") or E // H, F=cfg["intermediate_size"],
                V=cfg["vocab_size"], L=cfg["num_hidden_layers"],
                X=cfg.get("num_local_experts", 0),
                K=cfg.get("num_experts_per_tok", 0),
                W=cfg.get("sliding_window") or 0,
                gated=cfg["served_as"]["mlp"] == "gated")


def layer_params(cfg: dict) -> int:
    """Active matrix parameters of one layer a token: the four attention
    projections and the MLP, or the router and k experts."""
    s = sizes(cfg)
    E, H, KvH, Dh, Fd = s["E"], s["H"], s["KvH"], s["Dh"], s["F"]
    attn = 2 * E * H * Dh + 2 * E * KvH * Dh
    if s["X"]:
        return attn + E * s["X"] + s["K"] * 3 * E * Fd
    return attn + (3 if s["gated"] else 2) * E * Fd


def keys_reached(S: int, W: int) -> int:
    """Keys the S queries of a causal prefill reach in all: query i (from
    1) reaches min(i, W) of them (W = 0: no window)."""
    if not W or S <= W:
        return S * (S + 1) // 2
    return W * (W + 1) // 2 + (S - W) * W


def prefill_flops(cfg: dict, S: int) -> float:
    s = sizes(cfg)
    attn = 4 * s["H"] * s["Dh"] * keys_reached(S, s["W"])
    return s["L"] * (2.0 * layer_params(cfg) * S + attn) \
        + 2.0 * s["E"] * s["V"]


def decode_flops(cfg: dict, contexts) -> float:
    """One decode step over the active sequences whose caches hold
    ``contexts`` tokens before it: each new token reaches min(c + 1, W)."""
    s = sizes(cfg)
    c = np.asarray(contexts, np.int64) + 1
    if s["W"]:
        c = np.minimum(c, s["W"])
    n = len(c)
    return s["L"] * (2.0 * layer_params(cfg) * n
                     + 4.0 * s["H"] * s["Dh"] * float(c.sum())) \
        + 2.0 * s["E"] * s["V"] * n


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of its operations at
    the bf16 peak and its bytes at HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flash_prefill_call(cfg: dict, S: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal flash-prefill call over S tokens: the
    two products over the keys each query reaches; q, k, v read once and o
    written once, all bf16."""
    s = sizes(cfg)
    flops = 4.0 * s["H"] * s["Dh"] * keys_reached(S, s["W"])
    elems = S * s["Dh"] * (2 * s["H"] + 2 * s["KvH"])
    return flops, elems * BYTES["bfloat16"]


def decode_attention_call(cfg: dict, lengths, cache_dtype: str
                          ) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode-attention call over every slot of the
    engine (the step attends them all, as it does): slot b reads
    min(lengths[b] + 1, W) rows of K and V in the cache's dtype; q (bf16)
    read and o (bf16) written once, the lengths (int32) read once."""
    s = sizes(cfg)
    rows = np.asarray(lengths, np.int64) + 1
    if s["W"]:
        rows = np.minimum(rows, s["W"])
    B, n = len(rows), float(rows.sum())
    flops = 4.0 * s["H"] * s["Dh"] * n
    nbytes = 2 * n * s["KvH"] * s["Dh"] * BYTES[cache_dtype] \
        + 2 * B * s["H"] * s["Dh"] * BYTES["bfloat16"] + 4 * B
    return flops, nbytes
