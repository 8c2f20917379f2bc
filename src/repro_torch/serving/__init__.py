"""Serving: the paged ``LLMEngine``, its scheduler, backend and sampler."""

from repro_torch.serving.engine import LLMEngine  # noqa: F401
from repro_torch.serving.request import (  # noqa: F401
    FINISH_LENGTH,
    FINISH_STOP,
    Request,
    RequestOutput,
    SamplingParams,
)
