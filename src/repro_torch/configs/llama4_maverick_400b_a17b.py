"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 every 2nd layer (≈400B total
/ ≈17B active); chunked local attention (8192) with full-attention (NoPE)
layers every 4th. [hf:meta-llama/Llama-4-Scout-17B-16E family]

Early fusion: image tokens enter the shared token stream through the (stub)
frontend embedding path, so the backbone treats them as ordinary positions —
the assignment's frontend carve-out applies to the patch encoder only.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    layer_pattern=("chunk", "chunk", "chunk", "global"),
    window=8192,
    rope_theta=500_000.0,
    act="silu",
    tie_embeddings=False,
    n_experts=128,
    top_k=1,
    moe_every=2,
)
