"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [moe]: 48L d_model=2048 16H
(GQA kv=16) vocab=163840, MoE 64 experts top-6 (expert d_ff=1408).
[hf:moonshotai/Moonlight-16B-A3B]
"""

from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    d_model=2048,
    n_layers=48,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    layer_pattern=(LayerSpec(kind="attn", ffn="moe"),),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408, capacity_factor=1.25),
    rope_theta=50000.0,
    tie_embeddings=False,
    max_seq_len=131072,
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab=512,
    layer_pattern=(LayerSpec(kind="attn", ffn="moe"),),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32, capacity_factor=2.0,
                  num_shared_experts=1),
    tie_embeddings=False,
    max_seq_len=1024,
    compute_dtype="float32",
)
