"""Architecture configuration shared by all model families.

Port of ``src/repro/models/config.py``: a plain copy (pure Python, no JAX),
kept here because the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None    # default d_model // n_heads

    # --- per-layer kind pattern (cycled over depth) --------------------
    # kinds: "global" (full causal), "local" (sliding window), "chunk"
    # (chunked local attention, llama4-style), "rglru" (RG-LRU recurrent
    # block), "ssd" (Mamba2 SSD block), "cross" (cross-attention to
    # frontend embeddings)
    layer_pattern: tuple[str, ...] = ("global",)
    window: int = 0                # sliding/chunked attention window
    # --- positions / projections ---------------------------------------
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0     # chatglm applies RoPE to half the dims
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu
    gated_mlp: bool = True         # SwiGLU/GeGLU vs. plain 2-matrix MLP
    embed_scale: bool = False      # gemma-style sqrt(d) embedding scaling
    tie_embeddings: bool = True
    # --- MoE ------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # MoE replaces MLP every k-th layer
    capacity_factor: float = 1.25
    # --- SSM (Mamba2) -----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_kernel: int = 4
    d_inner_mult: int = 2
    # --- RG-LRU (recurrentgemma) ----------------------------------------
    lru_width: int = 0
    # --- encoder-decoder / multimodal frontends ---------------------------
    encoder_layers: int = 0        # >0 => encoder-decoder (audio)
    frontend: str | None = None    # "audio" | "vision" embedding stub
    frontend_len: int = 0          # # stub embedding tokens
    frontend_dim: int = 0          # stub embedding dim (projected to d_model)
    # --- numerics ---------------------------------------------------------
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kinds(self) -> list[str]:
        p = self.layer_pattern
        return [p[i % len(p)] for i in range(self.n_layers)]

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_every == self.moe_every - 1)

    @property
    def period(self) -> int:
        """Length of the repeating block pattern (layer kind x MoE flag)."""
        import math
        if self.n_experts > 0:
            return math.lcm(len(self.layer_pattern), self.moe_every)
        return len(self.layer_pattern)

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0 or self.arch_type == "ssm"
        for k in self.layer_pattern:
            assert k in ("global", "local", "chunk", "rglru", "ssd", "cross")
        if "local" in self.layer_pattern or "chunk" in self.layer_pattern:
            assert self.window > 0, "windowed kinds need cfg.window"
        if "cross" in self.layer_pattern:
            assert self.frontend is not None and self.frontend_len > 0
        if self.encoder_layers:
            assert self.frontend is not None


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 256,
            n_heads: int = 4, d_ff: int = 512, vocab: int = 512,
            **kw) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers,
    d_model <= 512, <= 4 experts)."""
    import dataclasses as dc
    # preserve the family's GQA ratio at reduced size
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // ratio)
    upd = dict(
        name=cfg.name + "-reduced",
        n_layers=max(n_layers, cfg.period) if cfg.period <= 8 else n_layers,
        d_model=d_model, n_heads=n_heads,
        n_kv_heads=min(n_kv, n_heads),
        d_ff=d_ff, vocab=vocab, head_dim=None,
        window=min(cfg.window, 64) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4),
        frontend_len=min(cfg.frontend_len, 16) if cfg.frontend_len else 0,
        frontend_dim=min(cfg.frontend_dim, 128) if cfg.frontend_dim else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        ssm_state=min(cfg.ssm_state, 64) if cfg.ssm_state else 0,
        ssm_head_dim=min(cfg.ssm_head_dim, 32),
        lru_width=min(cfg.lru_width, d_model) if cfg.lru_width else 0,
        dtype="float32",
    )
    upd.update(kw)
    return dc.replace(cfg, **upd)
