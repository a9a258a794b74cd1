"""olmo-1b [dense]: non-parametric LayerNorm.

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304. [arXiv:2402.00838; hf]
OLMo uses a plain (gateless) MLP with d_ff=8192 and non-parametric LN.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="nonparam_ln",
    mlp="gelu",
    tie_embeddings=True,
    source="arXiv:2402.00838; hf",
))
