"""Decode models: split-K occupancy and the dense-vs-paged layout choice.

The port's copy of ``repro.core.perf_model``'s decode estimates:
``estimate_decode_splits`` (single-device branch only: the mesh-joint
placement scoring comes with the distributed slice), and
``estimate_dense_decode`` / ``estimate_paged_decode``, which
``kernels.plan.resolve_kv_layout`` ranks. They run on the H100's data-sheet
constants (``core.numa.H100``); their choices are a model's, not
measurements. And ``choose_steps_per_sync``, the fused decode's ticks per
host sync, which the engine feeds a measured tick and which charges the
measured ``HOST_SYNC_OVERHEAD_S``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.cache import layout as layout_lib
from repro_torch.core.numa import Topology

#: Fixed cost charged for the split path whenever num_splits > 1: the
#: combine kernel's launch and the partial-state allocations, as an eager
#: decode tick pays them. Measured by ``chip_smoke.py`` (its "split path
#: costs" line: host clock per call over back-to-back calls, one row of two
#: pages, where splitting saves nothing) at 17.09 µs on an NVIDIA H100 80GB
#: HBM3 at a 700 W power limit. The model's other terms are not calibrated
#: (PERF.md, open questions).
COMBINE_LAUNCH_OVERHEAD_S = 17e-6

#: Host cost of one decode sync that the card does not see: filling the
#: graph's input buffers, the replay's launch, reading the results back and
#: the engine's bookkeeping before the next sync. This is the per-token tax
#: the fused multi-step decode amortizes. Measured by ``chip_smoke.py`` (its
#: "host sync" line: host clock of one steps_per_sync=1 sync at the llama3-8b
#: paged serve shape, 8 rows, median of 10: 12.794 ms, minus the device time
#: of that sync's one-tick graph, 12.246 ms) at 0.548 ms on an NVIDIA H100
#: 80GB HBM3 at a 700 W power limit.
HOST_SYNC_OVERHEAD_S = 548e-6

#: Cap on ``choose_steps_per_sync``. Powers of two up to this bound the
#: fused decode's graphs at O(log MAX) per engine.
MAX_STEPS_PER_SYNC = 32


@dataclasses.dataclass(frozen=True)
class DecodeEstimate:
    """Model of one decode tick (one new token per sequence)."""

    layout: str          # "dense" | "paged:head_aligned"
    time: float          # seconds per tick
    hbm_bytes: float     # bytes filled from memory (after reuse)
    flops: float
    reuse_rate: float    # fraction of page reads served by reuse


def estimate_dense_decode(*, batch: int, num_q_heads: int, num_kv_heads: int,
                          capacity: int, head_dim: int, dtype_bytes: int,
                          topo: Topology) -> DecodeEstimate:
    """Dense per-slot stripes: every (batch, kv head) cell is charged its
    whole ``capacity``-token stripe, as the JAX package charges it (its
    pipeline copies every chunk; masking skips compute, not traffic). The
    port's K7 skips irrelevant chunks, so this overstates its traffic at
    short live lengths; the model is kept as the JAX package has it."""
    kv_bytes = 2.0 * batch * num_kv_heads * capacity * head_dim * dtype_bytes
    flops = 4.0 * batch * num_q_heads * capacity * head_dim
    t = max(flops / topo.peak_flops, kv_bytes / topo.hbm_bw)
    return DecodeEstimate(layout="dense", time=t, hbm_bytes=kv_bytes, flops=flops,
                          reuse_rate=0.0)


def estimate_paged_decode(*, batch: int, num_q_heads: int, num_kv_heads: int,
                          mean_len: int, page_size: int, head_dim: int, dtype_bytes: int,
                          topo: Topology, policy: str = layout_lib.HEAD_ALIGNED,
                          shared_prefix_len: int = 0) -> DecodeEstimate:
    """Paged pool: each cell walks only its live pages; the first
    ``shared_prefix_len`` tokens are one set of physical pages shared by
    all ``batch`` sequences, fetched once per tick and then reused.

    Only the head-major (``head_aligned``) placement exists in the port;
    the JAX package's ``interleaved`` placement charges an inter-domain
    link that an SM does not have, and raises here."""
    if policy != layout_lib.HEAD_ALIGNED:
        raise ValueError(f"unknown page placement policy {policy!r}")
    page_bytes = 2.0 * page_size * head_dim * dtype_bytes
    live_pages = -(-mean_len // page_size)
    shared_pages = min(shared_prefix_len // page_size, live_pages)
    private_pages = live_pages - shared_pages
    fetches = num_kv_heads * (batch * private_pages + shared_pages)
    reads = num_kv_heads * batch * live_pages
    hbm_bytes = fetches * page_bytes
    flops = 4.0 * batch * num_q_heads * mean_len * head_dim
    t = max(flops / topo.peak_flops, hbm_bytes / topo.hbm_bw)
    return DecodeEstimate(layout=f"paged:{policy}", time=t, hbm_bytes=hbm_bytes,
                          flops=flops, reuse_rate=1.0 - fetches / reads if reads else 0.0)


#: Cap on the split sweep (only bounds the candidate loop).
MAX_DECODE_SPLITS = 16


@dataclasses.dataclass(frozen=True)
class SplitEstimate:
    """Occupancy model of split-K decode for one shape: the chosen split
    count, its modelled time, the one-pass baseline, and the full sweep."""

    num_splits: int
    time: float                           # modelled tick seconds at num_splits
    base_time: float                      # num_splits == 1 baseline
    times: Tuple[Tuple[int, float], ...]  # the whole candidate sweep


def estimate_decode_splits(
    *,
    batch: int,
    num_q_heads: int,
    num_kv_heads: int,
    seq_kv: int,
    granule: int,
    head_dim: int,
    dtype_bytes: int,
    topo: Topology,
    window: Optional[int] = None,
    max_splits: int = MAX_DECODE_SPLITS,
) -> SplitEstimate:
    """Pick ``num_splits`` for a decode launch by occupancy.

    A decode tick exposes ``cells = batch x num_kv_heads`` parallel blocks
    (the GQA group rides inside a block). Splitting each cell's KV walk
    into ``s`` page ranges multiplies the block count by ``s`` at the price
    of a combine over the partial ``(acc, m, l)`` states. Per candidate:
    each (cell, split) streams ``kv_bytes / s`` at one domain's share of
    the memory bandwidth, in ``ceil(cells * s / num_domains)`` waves, and
    the whole tick can never beat ``cells * kv_bytes / hbm_bw``; ``s > 1``
    pays the state round trip plus :data:`COMBINE_LAUNCH_OVERHEAD_S`.
    ``granule``-sized units (pages, or the dense stripe's KV chunks) cap
    ``s`` so no split is empty.
    """
    cells = max(1, batch * num_kv_heads)
    group = max(1, num_q_heads // max(num_kv_heads, 1))
    domains = max(1, topo.num_domains)
    live = min(seq_kv, window) if (window and window > 0) else seq_kv
    units = max(1, -(-int(live) // max(int(granule), 1)))

    kv_bytes = 2.0 * seq_kv * head_dim * dtype_bytes        # per cell, K + V
    flops = 4.0 * group * live * head_dim                   # per cell
    bw_dom = topo.hbm_bw / domains
    fl_dom = topo.peak_flops / domains
    # Partial state per (cell, split): fp32 acc (group x d) + m + l, written
    # once and read once by the combine. The CUDA kernels do not pad the
    # group, unlike the TPU kernels' sublane padding.
    state_bytes = 2 * 4.0 * group * (head_dim + 2)

    def candidate(s: int) -> float:
        waves = -(-cells * s // domains)
        t = max(
            waves * max(kv_bytes / s / bw_dom, flops / s / fl_dom),
            cells * kv_bytes / topo.hbm_bw,
        )
        if s > 1:
            t += cells * s * state_bytes / topo.hbm_bw
            t += COMBINE_LAUNCH_OVERHEAD_S
        return t

    times = []
    best = None  # (time, s)
    for s in range(1, max(1, min(int(max_splits), units)) + 1):
        t = candidate(s)
        times.append((s, t))
        if best is None or t < best[0]:
            best = (t, s)
    return SplitEstimate(
        num_splits=best[1], time=best[0], base_time=times[0][1],
        times=tuple(times),
    )


def amortized_host_overhead(steps_per_sync: int) -> float:
    """Per-token host overhead when the engine syncs once per
    ``steps_per_sync`` ticks: :data:`HOST_SYNC_OVERHEAD_S` spread over the
    N tokens a sync produces."""
    return HOST_SYNC_OVERHEAD_S / max(int(steps_per_sync), 1)


def choose_steps_per_sync(*, decode_tick_s: float) -> int:
    """The fused decode's ticks per sync: the smallest power of two whose
    amortized host overhead drops below 10% of one tick, capped at
    :data:`MAX_STEPS_PER_SYNC` (the JAX package's rule)."""
    n = 1
    while n < MAX_STEPS_PER_SYNC and amortized_host_overhead(n) > 0.1 * max(decode_tick_s, 0.0):
        n *= 2
    return n
