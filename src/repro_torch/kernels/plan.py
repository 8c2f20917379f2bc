"""The attention-plan layer: one resolver for every attention phase.

Port of ``repro.kernels.plan``. An :class:`AttentionPlan` carries the phase
(prefill | extend | decode), the KV layout, the resolved ``MappingConfig``,
the concrete implementation and, for decode, the split-K ``num_splits``
chosen by ``core.perf_model.estimate_decode_splits`` on the H100 topology.

Implementations: ``"cuda"`` (the hand-written kernels), ``"plain"`` (their
plain PyTorch versions, on any device). ``"auto"`` resolves by the device of
the tensors: the kernels on CUDA, the plain versions on the CPU.

Mapping ``"auto"`` resolves to ``PAPER_MAPPINGS["swizzled_head_first"]`` in
this slice; the scored mapping resolver and the extend-route scorer of the
JAX package are listed in ROADMAP.md. No mapping changes an output.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from repro_torch.core import numa, perf_model
from repro_torch.kernels.flash_attention import PAPER_MAPPINGS, MappingConfig

PREFILL = "prefill"
EXTEND = "extend"
DECODE = "decode"
PHASES = (PREFILL, EXTEND, DECODE)

DENSE = "dense"
PAGED = "paged"

IMPLS = ("auto", "cuda", "plain")

DEFAULT_MAPPING = "swizzled_head_first"


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """One resolved attention schedule for a (phase, layout, shape, device)."""

    phase: str
    kv_layout: str
    impl: str                      # "cuda" | "plain"
    mapping: MappingConfig
    device_type: str               # "cuda" | "cpu"
    page_size: Optional[int] = None
    window: Optional[int] = None
    num_splits: int = 1


#: The machine plans are scored for. The port targets one H100; CPU runs
#: plan for it too, so a CPU test takes the same decisions as the card.
TOPOLOGY = numa.H100


def _resolve_impl(impl: str, device_type: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if device_type == "cuda" else "plain"
    if impl == "cuda" and device_type != "cuda":
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


@functools.lru_cache(maxsize=2048)
def _plan_cached(batch, num_q_heads, num_kv_heads, seq_q, seq_kv, head_dim,
                 phase, kv_layout, device_type, dtype_bytes, window, page_size,
                 mapping_name, impl) -> AttentionPlan:
    name = DEFAULT_MAPPING if mapping_name == "auto" else mapping_name
    mapping = PAPER_MAPPINGS[name]  # KeyError = fail fast
    num_splits = 1
    if phase == DECODE and kv_layout == PAGED:
        num_splits = perf_model.estimate_decode_splits(
            batch=batch, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            seq_kv=seq_kv, granule=page_size, head_dim=head_dim,
            dtype_bytes=dtype_bytes, topo=TOPOLOGY,
            window=window,
        ).num_splits
    return AttentionPlan(
        phase=phase, kv_layout=kv_layout,
        impl=_resolve_impl(impl, device_type), mapping=mapping,
        device_type=device_type, page_size=page_size, window=window,
        num_splits=num_splits,
    )


def plan_attention(shape: Tuple[int, int, int, int, int, int], *,
                   phase: str = PREFILL, kv_layout: str = DENSE,
                   device_type: str = "cuda", dtype_bytes: int = 2,
                   window: Optional[int] = None,
                   page_size: Optional[int] = None,
                   mapping_name: str = "auto", impl: str = "auto"
                   ) -> AttentionPlan:
    """Resolve the :class:`AttentionPlan` for ``shape`` = ``(batch,
    num_q_heads, num_kv_heads, seq_q, seq_kv, head_dim)``. For paged
    decode, ``seq_kv`` is the page-table width times the page size."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; expected one of {PHASES}")
    if kv_layout not in (DENSE, PAGED):
        raise ValueError(f"unknown kv layout {kv_layout!r}")
    if kv_layout == PAGED and page_size is None:
        raise ValueError("paged plans require page_size")
    b, hq, hkv, sq, skv, d = (int(x) for x in shape)
    return _plan_cached(
        b, hq, hkv, sq, skv, d, phase, kv_layout, device_type,
        int(dtype_bytes), int(window) if window else None,
        int(page_size) if page_size else None,
        mapping_name, impl,
    )


def plan_for_config(cfg, shape, *, device_type: str, **kw) -> AttentionPlan:
    """:func:`plan_attention` with the schedule/impl policy read from a
    ``ModelConfig`` (the only reader of ``cfg.mapping_name`` /
    ``cfg.attn_impl``)."""
    return plan_attention(shape, device_type=device_type,
                          mapping_name=cfg.mapping_name, impl=cfg.attn_impl,
                          **kw)


def with_mapping(cfg, mapping: Optional[str]):
    """``cfg`` with its schedule policy overridden and validated."""
    if mapping is not None and mapping != cfg.mapping_name:
        cfg = dataclasses.replace(cfg, mapping_name=mapping)
    if cfg.mapping_name != "auto":
        PAPER_MAPPINGS[cfg.mapping_name]  # KeyError = fail fast
    return cfg
