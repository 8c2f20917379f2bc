"""Serving request/response types: the public surface of the LLMEngine.

``SamplingParams`` carries everything that varies per request at decode
time (temperature / top-k / top-p / stop tokens / token budget / seed);
``Request`` binds a prompt to its params and scheduling priority; and
``RequestOutput`` is the incremental unit ``LLMEngine.step`` streams back
— the tokens appended *this* step plus the accumulated output and, once a
request terminates, its ``finish_reason``.

The port's copy of ``repro.serving.request``: the same types with the same
fields, so a request stream drives either engine. ``Request`` also accepts
the legacy keywords (``max_new_tokens``, ``eos_id``, ``temperature``), which
build the equivalent ``SamplingParams``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

#: ``RequestOutput.finish_reason`` values.
FINISH_STOP = "stop"       # a stop token was sampled (it is included)
FINISH_LENGTH = "length"   # max_tokens generated


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy, applied by ``serving.sampling``.

    ``temperature == 0`` is exact greedy (bitwise ``argmax``, no RNG).
    ``top_k == 0`` / ``top_p == 1.0`` disable those filters. ``seed`` keys
    this request's sample stream: outputs are reproducible for a given
    (params, prompt) no matter which batch rows the request shares a tick
    with, and resume after preemption continues the same stream (the
    stream position is the number of tokens generated so far). ``seed=None``
    lets the engine derive one from the request uid.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_tokens: int = 32
    stop_token_ids: Tuple[int, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))


class Request:
    """One generation request: ``uid`` + prompt + sampling + priority.

    Either pass ``sampling=SamplingParams(...)`` or the legacy keywords
    (``max_new_tokens`` / ``eos_id`` / ``temperature``), which are
    converted; mixing both is an error.
    Higher ``priority`` is admitted sooner and survives preemption longer.
    """

    __slots__ = ("uid", "prompt", "sampling", "priority", "_hash_cache")

    def __init__(
        self,
        uid: int,
        prompt: np.ndarray,
        sampling: Optional[SamplingParams] = None,
        priority: int = 0,
        *,
        max_new_tokens: Optional[int] = None,
        eos_id: Optional[int] = None,
        temperature: Optional[float] = None,
        seed: Optional[int] = None,
    ):
        legacy = (max_new_tokens is not None or eos_id is not None
                  or temperature is not None or seed is not None)
        if sampling is not None and legacy:
            raise ValueError(
                "pass either sampling=SamplingParams(...) or the legacy "
                "max_new_tokens/eos_id/temperature keywords, not both"
            )
        if sampling is None:
            sampling = SamplingParams(
                temperature=0.0 if temperature is None else temperature,
                max_tokens=32 if max_new_tokens is None else max_new_tokens,
                stop_token_ids=() if eos_id is None else (int(eos_id),),
                seed=seed,
            )
        self.uid = int(uid)
        self.prompt = np.asarray(prompt)
        self.sampling = sampling
        self.priority = int(priority)
        self._hash_cache = {}

    def page_hashes(self, page_size: int):
        """The prompt's chained page hashes (``cache.prefix``), memoized:
        the scheduler prices prefix matches every round a request waits,
        so the O(prompt) hash pass must not repeat per tick. The prompt
        is treated as immutable after construction."""
        if page_size not in self._hash_cache:
            from repro_torch.cache.prefix import page_hashes

            self._hash_cache[page_size] = page_hashes(self.prompt, page_size)
        return self._hash_cache[page_size]

    @property
    def max_new_tokens(self) -> int:
        """The token budget (the backend's admission math reads it)."""
        return self.sampling.max_tokens

    @property
    def eos_id(self) -> Optional[int]:
        """The first stop token, or None (the legacy keyword's reading)."""
        ids = self.sampling.stop_token_ids
        return ids[0] if ids else None

    @property
    def temperature(self) -> float:
        return self.sampling.temperature

    def clone(self) -> "Request":
        """A fresh request with the same uid, a copy of the prompt, the
        same sampling and priority: a request set can be run again."""
        return Request(self.uid, self.prompt.copy(), self.sampling, self.priority)

    def __repr__(self):
        return (f"Request(uid={self.uid}, prompt_len={len(self.prompt)}, "
                f"sampling={self.sampling}, priority={self.priority})")


@dataclasses.dataclass
class RequestOutput:
    """One streamed increment of a request's generation.

    ``new_tokens`` holds only the tokens appended since the previous
    emission for this request (replayed tokens after a preemption resume
    are *not* re-streamed); ``tokens`` is the full accumulated output.
    ``finish_reason`` is ``None`` while decoding, else ``FINISH_STOP`` /
    ``FINISH_LENGTH``. ``text`` is the detokenized form of ``new_tokens``
    when the engine was built with a ``detokenizer`` hook, else ``None``.
    """

    uid: int
    prompt_len: int
    new_tokens: List
    tokens: List
    finished: bool = False
    finish_reason: Optional[str] = None
    text: Optional[str] = None
