"""Analytic performance models: the port's copy of ``repro.core.perf_model``
(single-device functions), fitted to the H100 where it measures the card.

  * :func:`estimate` — the paper's hit-rate / roofline model of one FA2
    launch under a mapping (``_mean_kv_tiles``, :class:`AnalyticEstimate`),
    built on ``core.swizzle`` / ``core.acc`` / ``core.cache_sim``; the plan
    scores the prefill launch order with it on the H100's cache view
    (``core.numa.H100_L2``), and :func:`relative_performance` ranks mappings
    by it.
  * :func:`estimate_dense_decode` / :func:`estimate_paged_decode` — one
    decode tick's attention, which ``kernels.plan.resolve_kv_layout`` ranks
    and the engines' ``decode_time_model`` (the occupancy cap, the drift
    table) reads.
  * :func:`estimate_decode_splits` — the split-K occupancy model; its
    bandwidth terms, wave and launch costs are ``Topology`` fields and its
    combine cost :data:`COMBINE_LAUNCH_OVERHEAD_S`, fitted on the card
    (``core.numa.H100``); left at their defaults they give the JAX
    package's formula.
  * :func:`estimate_extend_prefill` (paged kernel or gather route; on the
    H100 fitted to both routes on the card, ``core.numa.ExtendTerms``),
    which the plan's extend-route scorer reads, and
    :func:`estimate_tier_transfer` and :func:`tier_transfer_beats_recompute`
    — what the scheduler's admission tie-break prices
    (``PagedBackend.prefill_time_saved``), the host link measured on the
    card (:data:`HOST_LINK_BW`, :data:`TIER_TRANSFER_FIXED_S`).
  * :func:`estimate_attention_plan` — one entry point that scores a plan.
  * :func:`choose_steps_per_sync`, fed a measured tick by the engine, with
    the measured :data:`HOST_SYNC_OVERHEAD_S`.

The mesh branch of the split model and ``estimate_sharded_paged_decode``
come with the distributed slice (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.cache import layout as layout_lib
from repro_torch.core import acc as acc_lib
from repro_torch.core import swizzle
from repro_torch.core.cache_sim import AttentionWorkload
from repro_torch.core.numa import Topology

#: Fixed cost charged for the split path whenever num_splits > 1: the
#: combine kernel's launch, as a node of the decode tick's CUDA graph (the
#: engines decode in graphs). Fitted with ``core.numa.H100``'s decode_*
#: terms by ``chip_smoke.py``'s plan phase (a) to one-launch graph replays
#: of bf16 K3 / K4 (see ``core.numa.H100``) on an NVIDIA H100 80GB HBM3 at a
#: 700 W power limit. (Host clock per eager call, it was 17 us.)
COMBINE_LAUNCH_OVERHEAD_S = 0.2667e-6

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
class AnalyticEstimate:
    mapping: str
    hit_rate: float
    time: float          # seconds per launch (model)
    hbm_bytes: float
    flops: float

    @property
    def throughput(self) -> float:
        return self.flops / self.time if self.time else 0.0


def _mean_kv_tiles(wl: AttentionWorkload) -> float:
    blocks = -(-wl.seq_len // wl.block_m)
    if not wl.causal:
        return float(wl.kv_tiles_total)
    return (blocks + 1) * wl.block_m / (2.0 * wl.block_n)


def estimate(mapping: str, wl: AttentionWorkload, topo: Topology, *,
             drift_tiles: int = 16) -> AnalyticEstimate:
    """The paper's model of one FA2 launch under ``mapping``, per domain in
    steady state. ``w`` slots per domain hold ``a`` distinct ACCs on
    average (from the mapping's dispatch order). If the resident ACCs' K/V
    fits the domain's cache, everything after the cold misses hits;
    otherwise each stream's leader misses and its ``w / a - 1`` followers
    hit, provided the drift window of the ``a`` streams fits, else the hit
    rate collapses to a 0.02 residual. Time is the roofline of the flops
    against the missed bytes."""
    blocks = -(-wl.seq_len // wl.block_m)
    grid = dataclasses.replace(wl.grid, blocks_per_head=blocks)
    w = topo.slots_per_domain
    a = swizzle.accs_per_domain_concurrent(mapping, grid, topo.num_domains, w)
    a = max(a, 1.0)

    info = acc_lib.acc_info(grid, seq_len_kv=wl.seq_len, head_dim=wl.head_dim,
                            block_m=wl.block_m, dtype_bytes=wl.dtype_bytes)
    mean_tiles = _mean_kv_tiles(wl)
    accesses_per_wg = 1 + 2 * mean_tiles
    total_wgs = grid.total_wgs
    accesses = total_wgs * accesses_per_wg

    if a * info.kv_bytes <= topo.cache_bytes:
        # Resident regime: each domain cold-loads its ACCs' KV once.
        unique_accs = grid.batch * grid.num_accs
        cold = unique_accs * (2 * wl.kv_tiles_total) / max(topo.num_domains, 1)
        # naive mappings replicate ACCs across all domains:
        if mapping in (swizzle.NAIVE_HEAD_FIRST, swizzle.NAIVE_BLOCK_FIRST):
            cold *= topo.num_domains
        hit = max(0.0, 1.0 - cold * topo.num_domains / accesses)
    else:
        # Streaming regime: leader-miss / follower-hit within each stream,
        # if the drift window of `a` concurrent streams fits in cache.
        window_bytes = a * drift_tiles * 2 * wl.kv_tile_bytes * (w / a)
        if window_bytes <= topo.cache_bytes:
            hit = max(0.0, 1.0 - a / w)
        else:
            hit = 0.02  # residual (Q tiles, boundary reuse)

    flops = total_wgs * mean_tiles * wl.flops_per_tile_pair
    hbm_bytes = (1 - hit) * accesses * 2 * wl.kv_tile_bytes
    t_compute = flops / topo.peak_flops
    t_mem = hbm_bytes / topo.hbm_bw
    return AnalyticEstimate(mapping=mapping, hit_rate=hit, time=max(t_compute, t_mem),
                            hbm_bytes=hbm_bytes, flops=flops)


@dataclasses.dataclass(frozen=True)
class DecodeEstimate:
    """Model of one decode tick (one new token per sequence)."""

    layout: str          # "dense" | "paged:head_aligned"
    time: float          # seconds per tick
    hbm_bytes: float     # bytes filled from memory (after reuse)
    flops: float
    reuse_rate: float    # fraction of page reads served by reuse
    link_bytes: float = 0.0   # bytes crossing domains (the gather route)


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

    @property
    def speedup(self) -> float:
        return self.base_time / self.time if self.time else 0.0


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
    each (cell, split) streams ``kv_bytes / s`` at ``topo``'s per-cell rate
    (``decode_stream_bw``; a domain's share of ``hbm_bw`` by default) in
    ``ceil(cells * s / num_domains)`` waves, each wave paying
    ``decode_wave_s``; the whole launch can never beat ``cells * kv_bytes``
    at ``decode_hbm_bw`` and pays ``decode_launch_s`` once; ``s > 1`` pays
    the state round trip, the combine's fixed cost (``decode_combine_s``,
    else :data:`COMBINE_LAUNCH_OVERHEAD_S`) and ``decode_split_s`` per
    split (the combine walks the partials in turn).
    ``granule``-sized units (pages, or the dense stripe's KV chunks) cap
    ``s`` so no split is empty. With ``topo``'s split terms at their
    defaults this is the JAX package's single-device formula.
    """
    cells = max(1, batch * num_kv_heads)
    group = max(1, num_q_heads // max(num_kv_heads, 1))
    domains = max(1, topo.num_domains)
    live = min(seq_kv, window) if (window and window > 0) else seq_kv
    units = max(1, -(-int(live) // max(int(granule), 1)))

    kv_bytes = 2.0 * seq_kv * head_dim * dtype_bytes        # per cell, K + V
    flops = 4.0 * group * live * head_dim                   # per cell
    bw_dom = (topo.hbm_bw / domains if topo.decode_stream_bw is None
              else topo.decode_stream_bw)
    hbm_bw = topo.hbm_bw if topo.decode_hbm_bw is None else topo.decode_hbm_bw
    fl_dom = topo.peak_flops / domains
    # Partial state per (cell, split): fp32 acc (gp x d) + m + l, written
    # once and read once by the combine; the group padded to state_rows.
    rows = max(1, topo.state_rows)
    gp = max(rows, -(-group // rows) * rows)
    state_bytes = 2 * 4.0 * gp * (head_dim + 2)
    combine = (COMBINE_LAUNCH_OVERHEAD_S if topo.decode_combine_s is None
               else topo.decode_combine_s)

    def candidate(s: int) -> float:
        waves = -(-cells * s // domains)
        t = topo.decode_launch_s + max(
            waves * (topo.decode_wave_s + max(kv_bytes / s / bw_dom, flops / s / fl_dom)),
            cells * kv_bytes / hbm_bw,
        )
        if s > 1:
            t += cells * s * state_bytes / topo.hbm_bw
            t += combine + s * topo.decode_split_s
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


#: Device <-> host page-transfer rate of the host KV tier, and the fixed
#: cost of one transfer: a least-squares line through round trips of 1, 2,
#: 4 and 8 llama3-8b page payloads of 2 MiB (``chip_smoke.py``'s plan phase
#: (c): ``PagedBackend._page_payload`` to pinned host, packing included,
#: then ``_restore_page`` back; host clock around a synchronize, median of
#: 10, half a round trip per transfer: 1.908 / 3.756 / 7.371 / 13.713 ms) on
#: an NVIDIA H100 80GB HBM3 at a 700 W power limit. The per-page packing
#: and its ~130 small copies dominate, so this is an effective rate, far
#: below the link's; host-clock readings of one page moved between 1.27
#: and 1.91 ms from call to call. The JAX package charges 32 GB/s and one
#: host sync.
HOST_LINK_BW = 1.248e9
TIER_TRANSFER_FIXED_S = 0.3864e-3


def estimate_tier_transfer(nbytes: int) -> float:
    """Modelled seconds to move ``nbytes`` of demoted / promoted KV pages
    across the device <-> host link: :data:`TIER_TRANSFER_FIXED_S` plus the
    bytes at :data:`HOST_LINK_BW`."""
    return TIER_TRANSFER_FIXED_S + max(int(nbytes), 0) / HOST_LINK_BW


def tier_transfer_beats_recompute(nbytes: int, recompute_s: float) -> bool:
    """Is restoring ``nbytes`` of pages over the host link modelled faster
    than recomputing them (``recompute_s``, e.g. the extend-prefill
    delta)?"""
    return estimate_tier_transfer(nbytes) < max(recompute_s, 0.0)


def estimate_extend_prefill(
    *,
    batch: int,
    num_q_heads: int,
    num_kv_heads: int,
    prefix_len: int,
    tail_len: int,
    page_size: int,
    head_dim: int,
    dtype_bytes: int,
    topo: Topology,
    policy: str = layout_lib.HEAD_ALIGNED,
    gather: bool = False,
) -> DecodeEstimate:
    """Prefix-extension prefill: ``tail_len`` new queries attending a
    ``prefix_len``-token paged prefix plus their own causal tail.

    ``gather=False`` models the paged prefill kernel (K2): each (batch,
    kv head) cell streams the prefix's pages once plus the tail K/V, on an
    occupied share ``min(1, cells / num_domains)`` of the chip.
    ``gather=True`` models the route that copies the prefix to a dense
    stripe and runs the dense flash kernel: ~3x the prefix bytes, at the
    dense grid's occupancy. The pool is head-major (``HEAD_ALIGNED``) only,
    as in :func:`estimate_paged_decode`; the gather copy is charged the
    link. That is the JAX package's formula. Where ``topo.extend`` holds
    fitted terms (``core.numa.ExtendTerms``), the time is the port's
    kernels' instead (:func:`_extend_time_fitted`); the other fields stay
    the JAX formula's."""
    if policy != layout_lib.HEAD_ALIGNED:
        raise ValueError(f"unknown page placement policy {policy!r}")
    d = max(topo.num_domains, 1)
    page_bytes = 2.0 * page_size * head_dim * dtype_bytes
    prefix_pages = -(-prefix_len // page_size)
    prefix_bytes = batch * num_kv_heads * prefix_pages * page_bytes
    tail_bytes = 2.0 * batch * num_kv_heads * tail_len * head_dim * dtype_bytes
    q_bytes = 2.0 * batch * num_q_heads * tail_len * head_dim * dtype_bytes
    # Gathering to a dense stripe forfeits head alignment: the copy lands
    # wherever the allocator put the dense buffer.
    link_bytes = prefix_bytes * (d - 1) / d if gather else 0.0
    # Causal tail: each query row scores prefix_len + ~half the tail.
    flops = 4.0 * batch * num_q_heads * tail_len * (
        prefix_len + tail_len / 2.0
    ) * head_dim
    t_link = link_bytes / max(topo.link_bw * d, 1.0)
    if gather:
        hbm_bytes = 3.0 * prefix_bytes + tail_bytes + q_bytes
        flash_cells = batch * num_q_heads * max(1, -(-tail_len // 128))
        occ = min(1.0, flash_cells / d)
        t_copy = 2.0 * prefix_bytes / topo.hbm_bw + t_link
        flash_bytes = prefix_bytes + tail_bytes + q_bytes
        t = t_copy + max(
            flops / (topo.peak_flops * occ),
            flash_bytes / (topo.hbm_bw * occ),
        )
    else:
        hbm_bytes = prefix_bytes + tail_bytes + q_bytes
        occ = min(1.0, (batch * num_kv_heads) / d)
        t_mem = hbm_bytes / (topo.hbm_bw * occ) + t_link
        t = max(flops / (topo.peak_flops * occ), t_mem)
    if topo.extend is not None:
        t = _extend_time_fitted(topo, batch=batch, num_q_heads=num_q_heads,
                                prefix_len=prefix_len, tail_len=tail_len, head_dim=head_dim,
                                prefix_bytes=prefix_bytes, gather=gather)
    # Reuse = fraction of logical prefix reads (one per q head) served
    # without a physical fetch; the gather route's 3x eats into it.
    group = max(1, num_q_heads // max(num_kv_heads, 1))
    logical = group * prefix_bytes
    fetched = prefix_bytes * (3.0 if gather else 1.0)
    return DecodeEstimate(
        layout=f"extend:{'gather' if gather else 'paged'}",
        time=t, hbm_bytes=hbm_bytes, link_bytes=link_bytes, flops=flops,
        reuse_rate=max(0.0, 1.0 - fetched / logical) if logical else 0.0,
    )


def extend_blocks(*, batch: int, num_q_heads: int, prefix_len: int, tail_len: int,
                  head_dim: int, tile_rows: int) -> Tuple[int, float]:
    """(blocks, operations) of one K2 launch over an extend, or of K1 over
    the gather route's stripe: ``batch x num_q_heads x ceil(tail_len /
    tile_rows)`` blocks of ``tile_rows`` rows, each over ``ceil(prefix_len
    / tile_rows)`` prefix tiles and, on average over the blocks of a head,
    ``(T + 1) / 2`` tail tiles of ``tile_rows`` keys (T the tail's tiles):
    the rows and keys the tensor cores compute, padding included."""
    tiles = max(1, -(-tail_len // tile_rows))
    blocks = batch * num_q_heads * tiles
    keys = tile_rows * (-(-prefix_len // tile_rows) + (tiles + 1) / 2.0)
    return blocks, 4.0 * blocks * tile_rows * keys * head_dim


def _extend_time_fitted(topo: Topology, *, batch: int, num_q_heads: int, prefix_len: int,
                        tail_len: int, head_dim: int, prefix_bytes: float,
                        gather: bool) -> float:
    """Seconds of a paged extend on the port's kernels, priced with
    ``topo.extend``: the launch's fixed cost plus its operations
    (:func:`extend_blocks`) over the rate of the blocks in flight, at most
    one per domain (an SM holds one such block). The gather route adds its
    copies, ``2 x prefix_bytes`` over their rate, and K1 runs the same
    blocks at K1's rate."""
    x = topo.extend
    blocks, flops = extend_blocks(batch=batch, num_q_heads=num_q_heads,
                                  prefix_len=prefix_len, tail_len=tail_len,
                                  head_dim=head_dim, tile_rows=x.tile_rows)
    in_flight = min(blocks, max(topo.num_domains, 1))
    if gather:
        return (x.gather_s + 2.0 * prefix_bytes / x.gather_bw
                + flops / (x.gather_cell_flops * in_flight))
    return x.paged_launch_s + flops / (x.paged_cell_flops * in_flight)


def estimate_attention_plan(plan, shape, *, topo: Topology, dtype_bytes: int = 2):
    """Score a ``kernels.plan.AttentionPlan`` for ``shape`` = ``(batch,
    num_q_heads, num_kv_heads, seq_q, seq_kv, head_dim)``: decode ->
    :func:`estimate_paged_decode` / :func:`estimate_dense_decode`; paged
    extend -> :func:`estimate_extend_prefill` of the plan's route (K2, or
    the gather route where the plan's impl is ``"gather"``); prefill ->
    :func:`estimate` of the plan's launch order at K1's tiles for
    ``dtype_bytes``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import plan as plan_lib

    b, hq, hkv, sq, skv, hd = (int(x) for x in shape)
    if plan.phase == plan_lib.DECODE:
        if plan.kv_layout == plan_lib.PAGED:
            return estimate_paged_decode(
                batch=b, num_q_heads=hq, num_kv_heads=hkv, mean_len=skv,
                page_size=plan.page_size, head_dim=hd, dtype_bytes=dtype_bytes, topo=topo)
        return estimate_dense_decode(
            batch=b, num_q_heads=hq, num_kv_heads=hkv, capacity=skv, head_dim=hd,
            dtype_bytes=dtype_bytes, topo=topo)
    if plan.phase == plan_lib.EXTEND and plan.kv_layout == plan_lib.PAGED:
        return estimate_extend_prefill(
            batch=b, num_q_heads=hq, num_kv_heads=hkv, prefix_len=skv - sq,
            tail_len=sq, page_size=plan.page_size, head_dim=hd,
            dtype_bytes=dtype_bytes, topo=topo, gather=plan.impl == plan_lib.GATHER)
    block_m, block_n = fa.tiles(dtype_bytes, hd)
    grid = swizzle.AttentionGrid(batch=b, num_q_heads=hq,
                                 blocks_per_head=-(-skv // block_m),
                                 group_size=max(1, hq // max(hkv, 1)))
    wl = AttentionWorkload(grid=grid, seq_len=skv, head_dim=hd, block_m=block_m,
                           block_n=block_n, causal=True, dtype_bytes=dtype_bytes)
    return estimate(plan_lib.PAPER_NAME[plan.mapping.order], wl, topo)


def relative_performance(wl: AttentionWorkload, topo: Topology,
                         baseline: str = swizzle.SWIZZLED_HEAD_FIRST,
                         mappings=swizzle.ALL_MAPPINGS) -> Dict[str, float]:
    """Throughput of each mapping relative to the baseline (paper Figs
    12/14/15)."""
    ests = {m: estimate(m, wl, topo) for m in mappings}
    base = ests[baseline].throughput
    return {m: (e.throughput / base if base else 0.0) for m, e in ests.items()}
