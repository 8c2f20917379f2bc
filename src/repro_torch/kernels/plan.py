"""The attention-plan layer: one resolver for every attention phase.

Port of ``repro.kernels.plan``. An :class:`AttentionPlan` carries the phase
(prefill | extend | decode), the KV layout, the resolved ``MappingConfig``,
the concrete implementation and, for decode, the split-K ``num_splits``
chosen by ``core.perf_model.estimate_decode_splits`` on the H100 topology
(``core.numa.H100``, fitted to the paged kernels K3/K4 on the card; dense
stripes on ``H100_DENSE_DECODE``, whose terms are not fitted);
dense decode also carries its KV ``chunk`` (:func:`decode_chunk`).
:func:`resolve_kv_layout` ranks the dense and paged layouts for a decode
mix with the decode models of ``core.perf_model``.

Implementations: ``"cuda"`` (the hand-written kernels), ``"plain"`` (their
plain PyTorch versions, on any device). ``"auto"`` resolves by the device of
the tensors: the kernels on CUDA, the plain versions on the CPU. A paged
EXTEND has a third, ``"gather"``: the prefix gathered to dense stripes, then
K1 with per-row query offsets (its plain version on the CPU). Under
``"auto"`` with prefix pages the plan scores it against the paged kernel K2
(:func:`_score_extend_route`, ``perf_model.estimate_extend_prefill`` on
:data:`TOPOLOGY`, whose extend terms are fitted to both routes on the card);
``impl="gather"`` pins it.

Mapping ``"auto"`` is scored, as in the JAX package, for PREFILL and
DECODE (:func:`_score_mapping`): the three launches Hopper has
(:data:`CANDIDATES`) are priced by ``core.perf_model.estimate`` on the
H100's cache view (``core.numa.H100_L2``), ties broken by the bytes K1
loads (``kernels.flash_attention.hbm_block_fetches``), then by rank. Paged
EXTEND carries the default. A pinned name fails fast when unknown. No
mapping changes an output.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from repro_torch.cache import layout as layout_lib
from repro_torch.cache import quant as quant_lib
from repro_torch.core import numa, perf_model
from repro_torch.kernels.decode_attention import STAGE as DECODE_BLOCK
from repro_torch.core import swizzle
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (
    BLOCK_FIRST,
    HEAD_FIRST,
    PAPER_MAPPINGS,
    MappingConfig,
    hbm_block_fetches,
)

PREFILL = "prefill"
EXTEND = "extend"
DECODE = "decode"
PHASES = (PREFILL, EXTEND, DECODE)

DENSE = "dense"
PAGED = "paged"

IMPLS = ("auto", "cuda", "plain")
#: The paged extend's gather route (see the module docstring).
GATHER = "gather"


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """One resolved attention schedule for a (phase, layout, shape, device)."""

    phase: str
    kv_layout: str
    impl: str                      # "cuda" | "plain" | "gather" (paged extend)
    mapping: MappingConfig
    device_type: str               # "cuda" | "cpu"
    page_size: Optional[int] = None
    window: Optional[int] = None
    num_splits: int = 1
    chunk: Optional[int] = None    # dense decode: the KV chunk of the walk
    prefix_pages: int = 0          # paged extend: the page table's width


#: The machine plans are scored for. The port targets one H100; CPU runs
#: plan for it too, so a CPU test takes the same decisions as the card.
#: Occupancy models (split-K, layouts, extend) read the SM view, the
#: mapping model the cache view (``core.numa``).
TOPOLOGY = numa.H100
CACHE_TOPOLOGY = numa.H100_L2
#: The dense decode kernels' split choice keeps the unfitted terms.
DENSE_DECODE_TOPOLOGY = numa.H100_DENSE_DECODE

#: The launches Hopper has, in rank order (the last key of the score): a
#: CTA's ``blockIdx`` decodes head-first or block-first, and walks its KV
#: tiles linearly or, head-first, in sawtooth (the JAX package's streaming
#: candidates; its resident and block-size variants have no launch here).
CANDIDATES = (
    MappingConfig(order=HEAD_FIRST, traversal=swizzle.LINEAR),
    MappingConfig(order=HEAD_FIRST, traversal=swizzle.SAWTOOTH),
    MappingConfig(order=BLOCK_FIRST, traversal=swizzle.LINEAR),
)

#: Launch order -> the paper's mapping name it is priced as. ``blockIdx``
#: decodes straight into (b, h, m) with no swizzle, so the naive names.
PAPER_NAME = {
    HEAD_FIRST: swizzle.NAIVE_HEAD_FIRST,
    BLOCK_FIRST: swizzle.NAIVE_BLOCK_FIRST,
}


def resolve_impl(impl: str, device_type: str) -> str:
    """``"auto"`` -> ``"cuda"`` on CUDA tensors, ``"plain"`` on CPU ones;
    a pinned ``"cuda"`` needs CUDA tensors. Shared by the attention plans
    and the SSM dispatch (``models.ssm._ssd``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if device_type == "cuda" else "plain"
    if impl == "cuda" and device_type != "cuda":
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def decode_chunk(capacity: int) -> int:
    """KV chunk of the dense decode kernels (K7/K8) for a stripe of
    ``capacity`` positions: the largest multiple of 8 that divides the
    capacity and is at most :data:`DECODE_BLOCK`, the 64 rows the kernel
    stages per step. Without such a divisor the chunk stays at
    ``min(DECODE_BLOCK, capacity)`` and ``ops.decode_attention`` pads the
    stripe to a whole number of chunks: only odd capacities pay the pad
    copy. The JAX package's ``_decode_chunk`` applies the same rule to its
    resolver's ``block_n``; the port's ``MappingConfig`` has no ``block_n``."""
    chunk = min(DECODE_BLOCK, capacity)
    if capacity % chunk:
        divisor = next((c for c in range(chunk, 7, -1)
                        if capacity % c == 0 and c % 8 == 0), None)
        if divisor is not None:
            chunk = divisor
    return chunk


@functools.lru_cache(maxsize=1024)
def _score_mapping(batch: int, num_q_heads: int, num_kv_heads: int, seq_q: int,
                   seq_kv: int, head_dim: int, dtype_bytes: int, decode: bool,
                   window: Optional[int]) -> MappingConfig:
    """The :data:`CANDIDATES` argmin of ``(time, bytes, rank)``: the
    analytic model's time on :data:`CACHE_TOPOLOGY`, the bytes K1 loads,
    the candidate's rank. As in the JAX package, a sliding window bounds
    the KV scored to the live span rounded up to a whole 128-key tile, and
    decode shapes score non-causal (they attend every prior position)."""
    from repro_torch.core import perf_model
    from repro_torch.core.cache_sim import AttentionWorkload

    group = max(1, num_q_heads // max(num_kv_heads, 1))
    causal = not decode
    if window is not None and window > 0:
        seq_kv = min(seq_kv, -(-(window + (0 if decode else seq_q)) // 128) * 128)
    block_m, block_n = fa.tiles(dtype_bytes, head_dim)
    # perf_model.estimate models a square (seq_kv x seq_kv) launch, as in
    # the JAX package; the exact rectangular traffic enters the tie-break.
    grid = swizzle.AttentionGrid(batch=batch, num_q_heads=num_q_heads,
                                 blocks_per_head=-(-seq_kv // block_m), group_size=group)
    wl = AttentionWorkload(grid=grid, seq_len=seq_kv, head_dim=head_dim, block_m=block_m,
                           block_n=block_n, causal=causal, dtype_bytes=dtype_bytes)
    best = None  # ((time, traffic, rank), config)
    for rank, cand in enumerate(CANDIDATES):
        est = perf_model.estimate(PAPER_NAME[cand.order], wl, CACHE_TOPOLOGY)
        traffic = hbm_block_fetches(
            batch=batch, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            seq_q=seq_q, seq_kv=seq_kv, head_dim=head_dim, dtype_bytes=dtype_bytes,
            mapping=cand, causal=causal, window=window)["total_bytes"]
        key = (est.time, traffic, rank)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


@functools.lru_cache(maxsize=512)
def _score_extend_route(batch: int, num_q_heads: int, num_kv_heads: int, tail_len: int,
                        prefix_len: int, page_size: int, head_dim: int, dtype_bytes: int,
                        topo: numa.Topology = None) -> str:
    """The paged extend's route for one shape, as in the JAX package:
    ``"paged"`` (K2, the prefix read through the table) or :data:`GATHER`,
    whichever ``perf_model.estimate_extend_prefill`` prices lower on
    ``topo`` (:data:`TOPOLOGY` by default); a tie keeps K2."""
    kw = dict(batch=batch, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
              prefix_len=prefix_len, tail_len=tail_len, page_size=page_size,
              head_dim=head_dim, dtype_bytes=dtype_bytes, topo=topo or TOPOLOGY)
    paged = perf_model.estimate_extend_prefill(gather=False, **kw)
    gather = perf_model.estimate_extend_prefill(gather=True, **kw)
    return "paged" if paged.time <= gather.time else GATHER


@functools.lru_cache(maxsize=2048)
def _plan_cached(batch, num_q_heads, num_kv_heads, seq_q, seq_kv, head_dim,
                 phase, kv_layout, device_type, dtype_bytes, split_dtype_bytes, window,
                 page_size, prefix_pages, mapping_name, impl) -> AttentionPlan:
    if mapping_name != "auto":
        mapping = PAPER_MAPPINGS[mapping_name]  # KeyError = fail fast
    elif phase == EXTEND and kv_layout == PAGED:
        # The paged prefill kernel takes no MappingConfig (its schedule is
        # the fixed head-first page walk): carry the default.
        mapping = MappingConfig()
    else:
        mapping = _score_mapping(batch, num_q_heads, num_kv_heads, seq_q, seq_kv,
                                 head_dim, dtype_bytes, phase == DECODE, window)
    num_splits = 1
    chunk = None
    if phase == DECODE:
        # The granule is what the kernel can split at: KV chunks for the
        # dense stripe, pages for the pool.
        if kv_layout == DENSE:
            chunk = decode_chunk(seq_kv)
        num_splits = perf_model.estimate_decode_splits(
            batch=batch, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            seq_kv=seq_kv, granule=chunk if kv_layout == DENSE else page_size,
            head_dim=head_dim, dtype_bytes=split_dtype_bytes,
            topo=DENSE_DECODE_TOPOLOGY if kv_layout == DENSE else TOPOLOGY,
            window=window,
        ).num_splits
    paged_extend = phase == EXTEND and kv_layout == PAGED
    if impl == GATHER:
        if not paged_extend:
            raise ValueError(f"impl={GATHER!r} is the paged extend's route; the plan is "
                             f"for {phase} over {kv_layout}")
        resolved = GATHER
    else:
        resolved = resolve_impl(impl, device_type)
        if paged_extend and impl == "auto" and prefix_pages > 0 and _score_extend_route(
                batch, num_q_heads, num_kv_heads, seq_q, prefix_pages * page_size,
                page_size, head_dim, dtype_bytes) == GATHER:
            resolved = GATHER
    return AttentionPlan(
        phase=phase, kv_layout=kv_layout, impl=resolved, mapping=mapping,
        device_type=device_type, page_size=page_size, window=window,
        num_splits=num_splits, chunk=chunk, prefix_pages=prefix_pages,
    )


def plan_attention(shape: Tuple[int, int, int, int, int, int], *,
                   phase: str = PREFILL, kv_layout: str = DENSE,
                   device_type: str = "cuda", dtype_bytes: int = 2,
                   window: Optional[int] = None,
                   page_size: Optional[int] = None, prefix_pages: int = 0,
                   mapping_name: str = "auto", impl: str = "auto",
                   kv_dtype: str = "fp32") -> AttentionPlan:
    """Resolve the :class:`AttentionPlan` for ``shape`` = ``(batch,
    num_q_heads, num_kv_heads, seq_q, seq_kv, head_dim)``. For paged
    decode, ``seq_kv`` is the page-table width times the page size; for
    dense decode, the stripe's capacity; for an extend, ``seq_q`` is the
    tail and ``seq_kv`` prefix plus tail, and a paged extend passes its
    table's width as ``prefix_pages`` (the extend route is scored only
    where it is above 0). ``impl`` is ``"auto"``, ``"cuda"``, ``"plain"``
    or, for a paged extend only, ``"gather"``. A quantized ``kv_dtype`` (paged
    only) scores the bytes its codes move: ``dtype_bytes`` becomes
    ``cache.quant.kv_itemsize``, as in the JAX package; except the split
    count, which keeps ``dtype_bytes``: the split terms are fitted to the
    bf16 kernels, and the quantized ones, which widen their codes to bf16
    stages, take a bf16 cell's time or more, not half of it (PERF.md §6)."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; expected one of {PHASES}")
    if kv_layout not in (DENSE, PAGED):
        raise ValueError(f"unknown kv layout {kv_layout!r}")
    if kv_layout == PAGED and page_size is None:
        raise ValueError("paged plans require page_size")
    quant_lib.validate_kv_dtype(kv_dtype)
    split_dtype_bytes = dtype_bytes
    if kv_dtype != "fp32":
        if kv_layout != PAGED:
            raise ValueError(f"kv_dtype={kv_dtype!r} requires the paged KV layout")
        dtype_bytes = quant_lib.kv_itemsize(kv_dtype)
    b, hq, hkv, sq, skv, d = (int(x) for x in shape)
    return _plan_cached(
        b, hq, hkv, sq, skv, d, phase, kv_layout, device_type,
        int(dtype_bytes), int(split_dtype_bytes), int(window) if window else None,
        int(page_size) if page_size else None, int(prefix_pages),
        mapping_name, impl,
    )


@functools.lru_cache(maxsize=256)
def _score_kv_layout(batch: int, num_q_heads: int, num_kv_heads: int, mean_len: int,
                     capacity: int, page_size: int, head_dim: int, dtype_bytes: int,
                     shared_prefix_len: int) -> str:
    dense = perf_model.estimate_dense_decode(
        batch=batch, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
        capacity=capacity, head_dim=head_dim, dtype_bytes=dtype_bytes, topo=TOPOLOGY)
    paged = perf_model.estimate_paged_decode(
        batch=batch, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
        mean_len=mean_len, page_size=page_size, head_dim=head_dim,
        dtype_bytes=dtype_bytes, topo=TOPOLOGY, policy=layout_lib.HEAD_ALIGNED,
        shared_prefix_len=shared_prefix_len)
    candidates = {"dense": dense.time, f"paged:{layout_lib.HEAD_ALIGNED}": paged.time}
    return min(candidates, key=candidates.get)


def resolve_kv_layout(shape: Tuple[int, int, int, int, int], *, capacity: int,
                      page_size: int = 64, dtype_bytes: int = 2,
                      shared_prefix_len: int = 0) -> str:
    """Rank KV layouts for a decode mix; returns ``"dense"`` or
    ``"paged:head_aligned"``.

    ``shape`` is ``(batch, num_q_heads, num_kv_heads, mean_len, head_dim)``
    — the decode batch and its mean live length; ``capacity`` is the dense
    per-slot stripe the paged layout would replace. Scored with
    ``core.perf_model``'s dense and paged decode models on the H100's
    data-sheet constants: a choice by model, not by measurement. The port's
    pool is head-major only, so the JAX package's third candidate, the
    interleaved placement, is not scored."""
    b, hq, hkv, mean_len, head_dim = (int(x) for x in shape)
    return _score_kv_layout(b, hq, hkv, mean_len, int(capacity), int(page_size),
                            head_dim, int(dtype_bytes), int(shared_prefix_len))


def plan_for_config(cfg, shape, *, device_type: str, **kw) -> AttentionPlan:
    """:func:`plan_attention` with the schedule/impl policy read from a
    ``ModelConfig`` (the only reader of ``cfg.mapping_name`` /
    ``cfg.attn_impl``). ``attn_impl="gather"`` pins the paged extend's
    gather route and leaves every other phase and layout at ``"auto"``, as
    the JAX package coerces a pinned impl per phase."""
    impl = cfg.attn_impl
    if impl == GATHER and not (kw.get("phase") == EXTEND and kw.get("kv_layout") == PAGED):
        impl = "auto"
    return plan_attention(shape, device_type=device_type,
                          mapping_name=cfg.mapping_name, impl=impl, **kw)


def with_mapping(cfg, mapping: Optional[str]):
    """``cfg`` with its schedule policy overridden and validated."""
    if mapping is not None and mapping != cfg.mapping_name:
        cfg = dataclasses.replace(cfg, mapping_name=mapping)
    if cfg.mapping_name != "auto":
        PAPER_MAPPINGS[cfg.mapping_name]  # KeyError = fail fast
    return cfg
