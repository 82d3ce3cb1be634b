"""Roofline-based step-cost model: the serving scheduler's virtual clock.

Port of ``src/repro/serving/costmodel.py``; the formulas are the
reference's.  The scheduler advances time by a roofline estimate of each
engine step, max(compute, memory), on the target hardware, as Arcus's
profiler learns accelerator service curves offline; here the
"accelerator" is the model executor and the curve is analytic.

The reference's default target is a TPU; the port states no TPU rate.  Its
``HardwareSpec`` defaults to the NVIDIA H100 SXM data-sheet peaks (dense
bf16 tensor-core FLOP/s and HBM3 bytes/s, per card), and a caller that
wants another target (a parity test: the reference's) passes its numbers.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig

#: NVIDIA H100 SXM data sheet, per card: dense bf16 FLOP/s, HBM bytes/s
H100_SXM = dict(flops=989.4e12, hbm=3.35e12)


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    chips: int = 1
    flops: float = H100_SXM["flops"]
    hbm: float = H100_SXM["hbm"]
    mfu: float = 0.5      # attainable fraction of peak compute
    mbu: float = 0.7      # attainable fraction of peak bandwidth


def param_bytes(cfg: ArchConfig, active_only: bool = True) -> float:
    """Approximate (active) parameter bytes touched per token (bf16)."""
    E, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    H, KvH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    per_layer = 0.0
    kinds = cfg.layer_kinds()
    for i, kind in enumerate(kinds):
        if kind in ("global", "local", "chunk", "cross"):
            per_layer += E * H * Dh + 2 * E * KvH * Dh + H * Dh * E
        elif kind == "rglru":
            W = cfg.lru_width or E
            per_layer += 2 * E * W + 2 * W * W + W * E
        elif kind == "ssd":
            Din = cfg.d_inner_mult * E
            G, N = cfg.ssm_groups, cfg.ssm_state
            per_layer += E * (2 * Din + 2 * G * N + Din // cfg.ssm_head_dim) \
                + Din * E
        if cfg.d_ff > 0:
            g = 3 if cfg.gated_mlp else 2
            if cfg.is_moe_layer(i):
                k = max(cfg.top_k, 1) if active_only else cfg.n_experts
                per_layer += k * g * E * F
            else:
                per_layer += g * E * F
    # + unembedding matrix (touched once per step)
    return 2.0 * per_layer + 2.0 * E * V


def flops_per_token(cfg: ArchConfig, context: int) -> float:
    """~2 * active-params + attention FLOPs at the given KV context."""
    base = param_bytes(cfg)  # bf16 bytes = 2*params -> FLOPs = 2*params
    attn = 0.0
    for kind in cfg.layer_kinds():
        if kind == "global":
            attn += 2 * 2 * cfg.n_heads * cfg.head_dim_ * context
        elif kind in ("local", "chunk"):
            attn += 2 * 2 * cfg.n_heads * cfg.head_dim_ * \
                min(context, cfg.window)
    return base + attn


def kv_bytes_per_token(cfg: ArchConfig, context: int) -> float:
    """KV-cache bytes read per decoded token."""
    b = 0.0
    for kind in cfg.layer_kinds():
        if kind == "global":
            b += 2 * cfg.n_kv_heads * cfg.head_dim_ * context * 2
        elif kind in ("local", "chunk"):
            b += 2 * cfg.n_kv_heads * cfg.head_dim_ * \
                min(context, cfg.window) * 2
        elif kind == "ssd":
            Din = cfg.d_inner_mult * cfg.d_model
            b += (Din // cfg.ssm_head_dim) * cfg.ssm_head_dim \
                * cfg.ssm_state * 4
        elif kind == "rglru":
            b += (cfg.lru_width or cfg.d_model) * 4
    return b


@dataclasses.dataclass(frozen=True)
class StepCostModel:
    cfg: ArchConfig
    hw: HardwareSpec = HardwareSpec()

    def prefill_s(self, batch: int, seq: int) -> float:
        fl = flops_per_token(self.cfg, seq // 2) * batch * seq
        t_c = fl / (self.hw.chips * self.hw.flops * self.hw.mfu)
        wb = param_bytes(self.cfg)
        t_m = wb / (self.hw.chips * self.hw.hbm * self.hw.mbu)
        return max(t_c, t_m)

    def decode_s(self, batch: int, context: int) -> float:
        fl = flops_per_token(self.cfg, context) * batch
        t_c = fl / (self.hw.chips * self.hw.flops * self.hw.mfu)
        bytes_ = param_bytes(self.cfg) \
            + kv_bytes_per_token(self.cfg, context) * batch
        t_m = bytes_ / (self.hw.chips * self.hw.hbm * self.hw.mbu)
        return max(t_c, t_m)
