"""Model configuration schema (the port's own copy of ``repro.configs.base``).

A ``ModelConfig`` fully determines parameter shapes and the layer stack:
``n_layers`` repetitions of ``layer_pattern`` (one ``LayerSpec`` per pattern
position). The fields and defaults match the JAX package's schema so a
config built here describes the same model. The port serves the
``attn``, ``mamba`` and ``hybrid`` layer kinds with ``ffn="mlp"``,
``"moe"`` or ``"none"`` (llama, gemma, mamba2, hymba, moonshot, mixtral),
gated cross-attention layers over stub image embeddings
(llama-3.2-vision), and ``num_codebooks`` > 1 token streams (musicgen).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position within the repeating layer pattern."""

    kind: str = "attn"            # "attn" | "mamba" | "hybrid"
    ffn: str = "mlp"              # "mlp" | "moe" | "none"
    window: Optional[int] = None  # sliding-window size; None = global
    cross_attn: bool = False      # cross-attend to encoder states (VLM)
    rope_theta: float = 10000.0


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Top-k routed experts (``models/moe.py``)."""

    num_experts: int = 8
    top_k: int = 2
    d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    router_z_loss: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block dimensions."""

    state_dim: int = 128         # N
    head_dim: int = 64           # P
    num_heads: int = 0           # 0 => derived: expand * d_model // head_dim
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    num_groups: int = 1          # B/C groups (GVA)
    impl: str = "auto"           # "auto" | "cuda" | "plain" (kernels/ssd.py)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # attention extras
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    qk_norm: bool = False
    # io
    tie_embeddings: bool = True
    num_codebooks: int = 1
    vision_tokens: int = 0        # >0: VLM with stub patch-embedding frontend
    vision_dim: int = 0
    embed_scale: bool = False     # gemma-style sqrt(d) embedding scale
    # runtime
    max_seq_len: int = 131072
    compute_dtype: str = "bfloat16"
    attn_impl: str = "auto"       # kernels/plan.py: "auto" | "cuda" | "plain" | "gather"
    mapping_name: str = "auto"    # "auto" or a PAPER_MAPPINGS name
    # training
    z_loss: float = 1e-4

    def pattern_for_depth(self) -> Tuple[Tuple[LayerSpec, ...], Tuple[LayerSpec, ...]]:
        """(the repeated pattern, the remainder layers after the last whole
        period): the JAX package's period scan, here only for its layer
        order and its parameter tree."""
        p = len(self.layer_pattern)
        rem = self.n_layers - self.n_periods * p
        return self.layer_pattern, self.layer_pattern[:rem]

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """The spec of every layer, in stack order."""
        pattern, rem = self.pattern_for_depth()
        return pattern * self.n_periods + rem
