"""Architecture config schema + registry (the port's own copy of
``repro.configs.base``, plain data with no framework import).

Every assigned architecture is a frozen :class:`ArchConfig`; reduced smoke
variants are derived with :meth:`ArchConfig.smoke`.  The model substrate
(``repro_torch.models.transformer``) consumes only this schema — adding an
arch is a new config file, not new model code.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    causal: bool = True

    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | nonparam_ln
    mlp: str = "swiglu"  # swiglu | gelu

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # hybrid (zamba2-style): a *shared* attention block every k layers
    shared_attn_every: int = 0

    # modality frontend stubs
    frontend: str = "none"  # none | patch | frames
    frontend_dim: int = 0
    n_vision_tokens: int = 0

    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    source: str = ""

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/logits shard
        cleanly on any reasonable model axis (standard TPU practice).  Pad
        logits are masked to -1e9; pad rows receive no gradient signal."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def block_kind(self) -> Tuple[str, ...]:
        if self.family in ("ssm",):
            return ("mamba",) * self.n_layers
        if self.family == "hybrid":
            return ("mamba",) * self.n_layers
        return ("attn",) * self.n_layers

    @property
    def supports_decode(self) -> bool:
        return self.causal  # encoder-only archs have no autoregressive decode

    @property
    def subquadratic(self) -> bool:
        """Whether long-context decode (500k) is feasible: SSM/hybrid only."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6 N D)."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            ds = self.ssm_state
            heads = self.ssm_heads
            conv_dim = di + 2 * ds
            # in_proj -> (z, x, B, C, dt), conv, A/D/dt_bias, norm, out_proj
            per_layer += d * (2 * di + 2 * ds + heads)
            per_layer += conv_dim * self.ssm_conv
            per_layer += 3 * heads + di
            per_layer += di * d
            per_layer += d  # pre-norm
        if self.family in ("dense", "moe", "vlm", "audio"):
            qkvo = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
            if self.qkv_bias:
                qkvo += (self.n_heads + 2 * self.n_kv_heads) * hd
            per_layer += qkvo
            if self.norm == "rmsnorm":
                per_layer += 2 * d
            if self.family == "moe":
                per_layer += d * self.n_experts  # router
                per_layer += self.n_experts * (3 * d * self.moe_d_ff)
            else:
                ff = 3 * d * self.d_ff if self.mlp == "swiglu" else 2 * d * self.d_ff
                per_layer += ff
        n += per_layer * self.n_layers
        if self.family == "hybrid" and self.shared_attn_every:
            qkvo = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
            n += qkvo + 3 * d * self.d_ff + 2 * d  # one shared block
        if self.frontend == "patch":
            n += self.frontend_dim * d
        if self.frontend == "frames":
            n += self.frontend_dim * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        inactive = (
            self.n_layers
            * (self.n_experts - self.moe_top_k)
            * 3
            * self.d_model
            * self.moe_d_ff
        )
        return full - inactive

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.shared_attn_every else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_d_ff=32 if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            shared_attn_every=2 if self.shared_attn_every else 0,
            frontend_dim=32 if self.frontend != "none" else 0,
            n_vision_tokens=4 if self.frontend == "patch" else 0,
            dtype="float32",
        )


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import (  # noqa: F401
        hubert_xlarge,
        mamba2_130m,
        olmo_1b,
        olmoe_1b_7b,
        qwen1p5_32b,
        qwen2_vl_2b,
        qwen3_1p7b,
        qwen3_moe_30b_a3b,
        yi_9b,
        zamba2_7b,
    )
