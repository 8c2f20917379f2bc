"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24 MHA) d_ff=6144
vocab=2048, decoder-only over 4 EnCodec codebooks (delay pattern).

The EnCodec frontend is a stub, as in the JAX package: inputs are the
discrete codebook tokens (B, S, K=4); the K codebooks' embeddings are summed
and the tied (K, V, D) table gives K parallel heads. [arXiv:2306.05284; hf]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    d_model=1536,
    n_layers=48,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    num_codebooks=4,
    layer_pattern=(LayerSpec(kind="attn", ffn="mlp"),),
    tie_embeddings=True,
    max_seq_len=65536,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    num_codebooks=4,
    layer_pattern=(LayerSpec(kind="attn", ffn="mlp"),),
    max_seq_len=1024,
    compute_dtype="float32",
)
