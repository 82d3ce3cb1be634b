"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,            # unused by the SSD mixer
    n_kv_heads=1,
    d_ff=0,               # Mamba2 blocks have no separate MLP
    vocab=50280,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    conv_kernel=4,
    d_inner_mult=2,
    tie_embeddings=True,
)
