"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144; 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    arch_type="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1_000_000.0,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
)
