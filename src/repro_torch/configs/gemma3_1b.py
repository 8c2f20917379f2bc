"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global pattern (window 512), qk-norm, dual rope thetas (10k
local / 1M global), head_dim 256. [hf:google/gemma-3-1b-pt]
Field for field the JAX package's config.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", ffn="mlp", window=512, rope_theta=10000.0)
_GLOBAL = LayerSpec(kind="attn", ffn="mlp", window=None, rope_theta=1000000.0)

CONFIG = ModelConfig(
    name="gemma3-1b",
    d_model=1152,
    n_layers=26,                      # 4 periods of 6 + 2 remainder (local)
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    layer_pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    qk_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    max_seq_len=524288,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke",
    d_model=64,
    n_layers=8,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=(
        LayerSpec(kind="attn", ffn="mlp", window=64),
        LayerSpec(kind="attn", ffn="mlp", window=64),
        LayerSpec(kind="attn", ffn="mlp", rope_theta=1000000.0),
    ),
    qk_norm=True,
    embed_scale=True,
    max_seq_len=1024,
    compute_dtype="float32",
)
