"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA with 8 KV heads. [arXiv:2407.21783]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    layer_pattern=(LayerSpec(kind="attn", ffn="mlp", rope_theta=500000.0),),
    rope_theta=500000.0,
    tie_embeddings=False,
    max_seq_len=131072,
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke",
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=(LayerSpec(kind="attn", ffn="mlp", rope_theta=500000.0),),
    tie_embeddings=False,
    max_seq_len=1024,
    compute_dtype="float32",
)
