"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024; 2d/partial RoPE (rotary on half the head dims), GQA, QKV bias.
[arXiv:2406.12793]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    arch_type="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    layer_pattern=("global",),
    rope_theta=10_000.0,
    rope_fraction=0.5,
    qkv_bias=True,
    act="silu",
    tie_embeddings=False,
)
