"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Alternating local (window 4096) / global layers, attention and final logit
softcaps, sqrt(d) embedding scale, head_dim 256. [arXiv:2408.00118; hf]
Field for field the JAX package's config.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", ffn="mlp", window=4096)
_GLOBAL = LayerSpec(kind="attn", ffn="mlp", window=None)

CONFIG = ModelConfig(
    name="gemma2-2b",
    d_model=2304,
    n_layers=26,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    layer_pattern=(_LOCAL, _GLOBAL),
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    tie_embeddings=True,
    max_seq_len=524288,
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke",
    d_model=64,
    n_layers=4,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=(
        LayerSpec(kind="attn", ffn="mlp", window=64),
        LayerSpec(kind="attn", ffn="mlp"),
    ),
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    max_seq_len=1024,
    compute_dtype="float32",
)
