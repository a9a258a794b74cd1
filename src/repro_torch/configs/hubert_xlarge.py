"""hubert-xlarge [audio]: encoder-only transformer over frame embeddings.

48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504. [arXiv:2106.07447;
unverified]

The CNN waveform frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (seq x frontend_dim=512) which a linear
projection maps to d_model.  Encoder-only: no decode shapes (DESIGN.md).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    mlp="gelu",
    norm="rmsnorm",
    frontend="frames",
    frontend_dim=512,
    source="arXiv:2106.07447; unverified",
))
