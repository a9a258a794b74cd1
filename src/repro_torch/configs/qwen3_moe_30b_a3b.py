"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8.

48L d_model=2048 32H (GQA kv=4) d_ff=768(per-expert) vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    n_experts=128,
    moe_top_k=8,
    moe_d_ff=768,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
