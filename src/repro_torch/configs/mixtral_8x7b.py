"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) vocab=32000.

8 experts top-2 (expert d_ff=14336), sliding-window attention (4096).
[arXiv:2401.04088; hf]
"""

from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    layer_pattern=(LayerSpec(kind="attn", ffn="moe", window=4096),),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=14336, capacity_factor=1.25),
    rope_theta=1000000.0,
    tie_embeddings=False,
    max_seq_len=524288,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=(LayerSpec(kind="attn", ffn="moe", window=64),),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=64, capacity_factor=2.0),
    tie_embeddings=False,
    max_seq_len=1024,
    compute_dtype="float32",
)
