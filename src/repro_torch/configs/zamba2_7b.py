"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242; unverified]

Faithfulness notes (DESIGN.md §Arch-applicability): the real Zamba2 uses two
alternating shared attention blocks whose input is concat(hidden, embedding);
we model ONE shared attention+MLP block applied every 6 Mamba2 layers on the
hidden stream alone — same parameter-sharing structure and FLOP profile.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
    source="arXiv:2411.15242; unverified",
))
