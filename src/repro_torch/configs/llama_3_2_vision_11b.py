"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]

The vision tower is a stub, as in the JAX package: callers pass
precomputed patch embeddings (B, 1600, 7680), which a learned projection
maps to d_model; the cross-attention layers (positions 3, 8, ...: every
5th) attend them behind a zero-initialised tanh gate.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_SELF = LayerSpec(kind="attn", ffn="mlp", rope_theta=500000.0)
_CROSS = LayerSpec(kind="attn", ffn="mlp", rope_theta=500000.0, cross_attn=True)

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    d_model=4096,
    n_layers=40,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    layer_pattern=(_SELF, _SELF, _SELF, _CROSS, _SELF),
    rope_theta=500000.0,
    vision_tokens=1600,
    vision_dim=7680,
    tie_embeddings=False,
    max_seq_len=131072,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    d_model=64,
    n_layers=5,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=(
        LayerSpec(kind="attn", ffn="mlp"),
        LayerSpec(kind="attn", ffn="mlp", cross_attn=True),
    ),
    vision_tokens=16,
    vision_dim=32,
    tie_embeddings=False,
    max_seq_len=1024,
    compute_dtype="float32",
)
