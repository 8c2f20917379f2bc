"""Model configurations served by the port."""

from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig  # noqa: F401
