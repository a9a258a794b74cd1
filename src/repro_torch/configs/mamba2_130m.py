"""mamba2-130m [ssm]: pure SSD, attention-free.

24L d_model=768 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
[arXiv:2405.21060; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
