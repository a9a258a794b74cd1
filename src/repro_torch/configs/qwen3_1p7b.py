"""qwen3-1.7b [dense]: GQA + qk_norm.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936. [hf:Qwen/Qwen3-8B; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
))
