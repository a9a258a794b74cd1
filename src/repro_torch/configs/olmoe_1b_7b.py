"""olmoe-1b-7b [moe]: 64 experts, top-8.

16L d_model=2048 16H (GQA kv=16) d_ff=1024(per-expert) vocab=50304.
[arXiv:2409.02060; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    qk_norm=True,
    n_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
    source="arXiv:2409.02060; hf",
))
