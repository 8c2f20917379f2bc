"""Model configuration schema (the port's own copy of ``repro.configs.base``).

A ``ModelConfig`` fully determines parameter shapes and the layer stack:
``n_layers`` repetitions of ``layer_pattern`` (one ``LayerSpec`` per pattern
position). The fields and defaults match the JAX package's schema so a
config built here describes the same model; the port serves only the
``kind="attn", ffn="mlp"`` stacks of the llama family so far.
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
    # attention extras
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    qk_norm: bool = False
    # io
    tie_embeddings: bool = True
    num_codebooks: int = 1
    embed_scale: bool = False     # gemma-style sqrt(d) embedding scale
    # runtime
    max_seq_len: int = 131072
    compute_dtype: str = "bfloat16"
    attn_impl: str = "auto"       # kernels/plan.py: "auto" | "cuda" | "plain"
    mapping_name: str = "auto"    # "auto" or a PAPER_MAPPINGS name

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """The spec of every layer, in stack order."""
        p = len(self.layer_pattern)
        return tuple(self.layer_pattern[i % p] for i in range(self.n_layers))
