"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA, RoPE, sliding-window 4096, LayerNorm + plain GeLU MLP.
[arXiv:2402.19173]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    layer_pattern=("local",),
    window=4096,
    rope_theta=100_000.0,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    qkv_bias=True,
    tie_embeddings=True,
)
