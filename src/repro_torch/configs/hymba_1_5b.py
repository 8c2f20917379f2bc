"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per layer.
[arXiv:2411.13676; hf]

Pattern: 1 global + 7 sliding-window hybrid layers per period (Hymba keeps
a few full-attention layers among mostly-SWA ones; meta-tokens are
omitted). head_dim = 1600/25 = 64. Field for field the JAX package's
config.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

_GLOBAL = LayerSpec(kind="hybrid", ffn="mlp", window=None)
_LOCAL = LayerSpec(kind="hybrid", ffn="mlp", window=1024)

CONFIG = ModelConfig(
    name="hymba-1.5b",
    d_model=1600,
    n_layers=32,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    layer_pattern=(_GLOBAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4,
                  chunk=256, num_groups=1),
    tie_embeddings=True,
    max_seq_len=524288,
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    d_model=64,
    n_layers=4,
    n_heads=5,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=(
        LayerSpec(kind="hybrid", ffn="mlp"),
        LayerSpec(kind="hybrid", ffn="mlp", window=64),
    ),
    ssm=SSMConfig(state_dim=8, head_dim=8, expand=2, conv_width=4,
                  chunk=32, num_groups=1),
    max_seq_len=1024,
    compute_dtype="float32",
)
