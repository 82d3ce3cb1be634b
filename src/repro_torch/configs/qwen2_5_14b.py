"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    layer_pattern=("global",),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    act="silu",
    tie_embeddings=False,
)
