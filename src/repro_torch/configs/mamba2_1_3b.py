"""mamba2-1.3b [ssm]: 48L d_model=2048, attention-free (SSD), d_ff=0,
vocab=50280, ssm_state=128. [arXiv:2405.21060]

No attention, so no K/V cache: decode carries a constant-size recurrent
state per layer. Field for field the JAX package's config.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    d_model=2048,
    n_layers=48,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    layer_pattern=(LayerSpec(kind="mamba", ffn="none"),),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256, num_groups=1),
    tie_embeddings=True,
    max_seq_len=1048576,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    d_model=64,
    n_layers=2,
    n_heads=1,
    n_kv_heads=1,
    head_dim=16,
    d_ff=0,
    vocab=512,
    layer_pattern=(LayerSpec(kind="mamba", ffn="none"),),
    ssm=SSMConfig(state_dim=16, head_dim=8, expand=2, conv_width=4,
                  chunk=32, num_groups=1),
    max_seq_len=1024,
    compute_dtype="float32",
)
