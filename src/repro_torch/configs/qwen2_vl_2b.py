"""qwen2-vl-2b [vlm]: M-RoPE, dynamic resolution (frontend stubbed).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. [arXiv:2409.12191; hf]

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (n_vision_tokens x frontend_dim) projected into
the first positions of the sequence.  M-RoPE degrades to 1-D RoPE for the
stubbed (pre-pooled) patch stream — noted in DESIGN.md.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    frontend="patch",
    frontend_dim=1280,
    n_vision_tokens=256,
    source="arXiv:2409.12191; hf",
))
