"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2 every layer, sliding-window attention (per
assignment). [arXiv:2401.04088]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    layer_pattern=("local",),
    window=4096,
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
    n_experts=8,
    top_k=2,
    moe_every=1,
)
