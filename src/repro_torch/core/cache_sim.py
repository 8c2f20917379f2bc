"""Event-driven NUMA cache simulator for attention workgroup schedules:
the port's copy of ``repro.core.cache_sim`` (pure Python).

It replays a launch at tile granularity: ``num_domains`` domains, each with
a private LRU cache of ``cache_bytes`` and ``slots_per_domain`` concurrent
workgroup slots; workgroup ``wid`` is queued on domain ``wid %
num_domains``; each workgroup's memory behaviour is its FA2 tile-access
stream (Q row-block once, then the K/V tile sequence; the backward variant
reads K/V once and streams Q/dO); an access to a line with an in-flight fill
waits for it and counts as a hit (MSHR coalescing); read-once operands are
non-temporal. A *dynamics* clock with miss-latency stalls orders the
concurrent workgroups; the throughput is a per-domain roofline. One domain
is simulated and its queue truncated to ``max_wgs`` workgroups (all four
mappings are domain-symmetric).

The calibration (``miss_latency=4`` tile-times, ``kernel_efficiency=0.72``)
is the JAX package's, made against the paper's MI300X figures; it is not a
measurement of the H100. The simulator is the repo's check on the analytic
model (``core.perf_model.estimate``) and the paper's L2 hit-rate argument.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import swizzle
from repro_torch.core.numa import Topology
from repro_torch.core.swizzle import AttentionGrid


@dataclasses.dataclass(frozen=True)
class AttentionWorkload:
    """One FA2 kernel launch to simulate."""

    grid: AttentionGrid
    seq_len: int
    head_dim: int
    block_m: int = 128
    block_n: int = 64
    causal: bool = True
    dtype_bytes: int = 2
    pass_: str = "fwd"  # "fwd" | "bwd"

    @property
    def kv_tiles_total(self) -> int:
        return -(-self.seq_len // self.block_n)

    def kv_tiles_for_block(self, m: int) -> int:
        """# of K/V tiles workgroup (.., m) reads (causal => prefix only)."""
        if not self.causal:
            return self.kv_tiles_total
        rows_end = min((m + 1) * self.block_m, self.seq_len)
        return -(-rows_end // self.block_n)

    @property
    def blocks_per_head(self) -> int:
        block = self.block_n if self.pass_ == "bwd" else self.block_m
        return -(-self.seq_len // block)

    @property
    def kv_tile_bytes(self) -> int:
        return self.block_n * self.head_dim * self.dtype_bytes

    @property
    def q_tile_bytes(self) -> int:
        return self.block_m * self.head_dim * self.dtype_bytes

    @property
    def flops_per_tile_pair(self) -> float:
        # QK^T + PV: two (block_m x block_n x head_dim) matmuls.
        return 4.0 * self.block_m * self.block_n * self.head_dim


@dataclasses.dataclass
class SimResult:
    mapping: str
    hits: int
    misses: int
    hbm_bytes: int          # one simulated domain, truncated queue
    elapsed: float          # seconds, one domain (roofline of compute vs HBM)
    compute_time: float
    hbm_time: float
    total_flops: float      # flops corresponding to the simulated accesses
    per_tensor: Dict[str, Tuple[int, int]]  # tensor -> (hits, misses)
    simulated_wgs: int
    total_wgs: int

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    @property
    def throughput(self) -> float:
        """Model FLOP/s per domain (meaningful as a ratio between mappings)."""
        return self.total_flops / self.elapsed if self.elapsed else 0.0

    @property
    def bound(self) -> str:
        return "memory" if self.hbm_time > self.compute_time else "compute"


def _stream_len(wl: AttentionWorkload, m: int) -> int:
    """Number of tile accesses in workgroup (b, h, m)'s stream."""
    if wl.pass_ == "fwd":
        return 1 + 2 * wl.kv_tiles_for_block(m)
    q_blocks = -(-wl.seq_len // wl.block_m)
    if wl.causal:
        first_q = (m * wl.block_n) // wl.block_m
        return 2 + 2 * (q_blocks - first_q)
    return 2 + 2 * q_blocks


def _access(wl: AttentionWorkload, b: int, h: int, hkv: int, m: int, pos: int):
    """pos-th access of the workgroup -> (tile_key, nbytes, shared).

    Keys are (tensor_tag, batch, head, tile_idx); shared tensors key on the
    *kv* head — that is what makes ACC sharing visible to the cache.
    ``shared=False`` operands are read once per workgroup and pinned in
    LDS/registers, streaming through L2 with a non-temporal policy.
    """
    if wl.pass_ == "fwd":
        if pos == 0:
            return ("Q", b, h, m), wl.q_tile_bytes, False
        j = (pos - 1) >> 1
        tag = "K" if (pos - 1) & 1 == 0 else "V"
        return (tag, b, hkv, j), wl.kv_tile_bytes, True
    if pos == 0:
        return ("K", b, hkv, m), wl.kv_tile_bytes, False
    if pos == 1:
        return ("V", b, hkv, m), wl.kv_tile_bytes, False
    first_q = (m * wl.block_n) // wl.block_m if wl.causal else 0
    j = first_q + ((pos - 2) >> 1)
    tag = "Q" if (pos - 2) & 1 == 0 else "dO"
    return (tag, b, h, j), wl.q_tile_bytes, True


class _LRU:
    __slots__ = ("cap", "used", "d")

    def __init__(self, cap: int):
        self.cap = cap
        self.used = 0
        self.d: OrderedDict = OrderedDict()

    def touch(self, key) -> bool:
        if key in self.d:
            self.d.move_to_end(key)
            return True
        return False

    def insert(self, key, nbytes: int) -> None:
        d = self.d
        if key in d:
            d.move_to_end(key)
            return
        d[key] = nbytes
        self.used += nbytes
        while self.used > self.cap and d:
            _, sz = d.popitem(last=False)
            self.used -= sz


def simulate(
    mapping: str,
    workload: AttentionWorkload,
    topo: Topology,
    *,
    max_wgs: Optional[int] = None,
    miss_latency: float = 4.0,
    kernel_efficiency: float = 0.72,
    miss_overhead: float = 0.25,
    chunk: int = 8,
    domain: int = 0,
) -> SimResult:
    """Simulate one domain of one launch under one mapping strategy.

    ``miss_overhead``: fraction of a tile-time of *exposed* (non-hidden)
    latency each miss adds to the compute-side clock — on real hardware
    occupancy hides most but not all fill latency. Calibrated so the
    Naive Head-first mapping lands at the paper's ~0.90x relative
    performance at N_CTX=128K while hit-rate-parity mappings stay at 1.0x.
    """
    wl = workload
    grid = dataclasses.replace(wl.grid, blocks_per_head=wl.blocks_per_head)
    d = topo.num_domains
    nslots = topo.slots_per_domain

    # Dispatch queue for the simulated domain, truncated for tractability.
    wids = np.arange(grid.total_wgs, dtype=np.int64)
    sel = wids[swizzle.domain_of(wids, d) == domain]
    total_wgs_domain = len(sel)
    if max_wgs is not None and len(sel) > max_wgs:
        sel = sel[:max_wgs]
    qb, qh, qm = swizzle.decode(mapping, sel, grid, d)
    qhkv = qh // grid.group_size
    qb = qb.astype(np.int64)
    nq = len(sel)

    t_tile = wl.flops_per_tile_pair / 2.0 / (topo.flops_per_slot * kernel_efficiency)
    lam = miss_latency  # in t_tile units on the dynamics clock

    lru = _LRU(topo.cache_bytes)
    inflight: Dict[tuple, float] = {}
    hits = misses = 0
    hbm_bytes = 0
    accesses = 0
    per_tensor: Dict[str, list] = {t: [0, 0] for t in ("Q", "K", "V", "dO")}

    heap = []
    qi = 0
    for s in range(nslots):
        if qi < nq:
            heapq.heappush(heap, (0.0, s, qi, 0))
            qi += 1
    while heap:
        t, s, wi, pos = heapq.heappop(heap)
        b = int(qb[wi]); h = int(qh[wi]); hkv = int(qhkv[wi]); m = int(qm[wi])
        slen = _stream_len(wl, m)
        stop = min(pos + chunk, slen)
        while pos < stop:
            key, nbytes, shared = _access(wl, b, h, hkv, m, pos)
            accesses += 1
            if shared and lru.touch(key):
                hits += 1
                per_tensor[key[0]][0] += 1
                t += 1.0
            else:
                f = inflight.get(key)
                if f is not None and f > t:
                    # Hit-under-miss: wait for the in-flight fill.
                    hits += 1
                    per_tensor[key[0]][0] += 1
                    t = f + 1.0
                else:
                    misses += 1
                    per_tensor[key[0]][1] += 1
                    hbm_bytes += nbytes
                    tf = t + lam
                    inflight[key] = tf
                    if shared:
                        lru.insert(key, nbytes)
                    t = tf + 1.0
            pos += 1
        if pos < slen:
            heapq.heappush(heap, (t, s, wi, pos))
        elif qi < nq:
            heapq.heappush(heap, (t, s, qi, 0))
            qi += 1
    # Periodically drop stale in-flight entries is unnecessary: dict stays
    # bounded by distinct tiles touched.

    # Roofline throughput for the simulated domain. KV-pair flops accrue per
    # K/V access pair => flops = (K+V accesses)/2 * pair_flops.
    kv_accesses = sum(per_tensor[k][0] + per_tensor[k][1] for k in ("K", "V"))
    if wl.pass_ == "bwd":
        # bwd does ~2.5x the matmul work of fwd per tile pair (5 matmuls).
        pair_accesses = sum(per_tensor[k][0] + per_tensor[k][1] for k in ("Q", "dO"))
        flops = pair_accesses / 2.0 * wl.flops_per_tile_pair * 2.5
    else:
        flops = kv_accesses / 2.0 * wl.flops_per_tile_pair
    compute_time = flops / (topo.peak_flops / d * kernel_efficiency)
    # Exposed fill latency: misses stall their slot for a calibrated fraction
    # of a tile-time beyond what occupancy hides; the domain runs `nslots`
    # slots in parallel, so the domain-level penalty is averaged over them.
    compute_time += misses * t_tile * miss_overhead / max(nslots, 1)
    hbm_time = hbm_bytes / (topo.hbm_bw / d)
    return SimResult(
        mapping=mapping,
        hits=hits,
        misses=misses,
        hbm_bytes=hbm_bytes,
        elapsed=max(compute_time, hbm_time),
        compute_time=compute_time,
        hbm_time=hbm_time,
        total_flops=flops,
        per_tensor={k: tuple(v) for k, v in per_tensor.items()},
        simulated_wgs=nq,
        total_wgs=total_wgs_domain,
    )


def default_max_wgs(workload: AttentionWorkload, budget_accesses: int = 3_000_000) -> int:
    """Truncate the per-domain queue so simulated accesses stay tractable.

    Keeps at least two full ACC passes so steady state (incl. the head
    transition) is represented.
    """
    mean = (
        1 + (workload.blocks_per_head + 1) * workload.block_m / workload.block_n
        if workload.causal
        else 1 + 2 * workload.kv_tiles_total
    )
    min_wgs = 2 * workload.grid.group_size * workload.blocks_per_head
    return max(int(budget_accesses / max(mean, 1)), min(min_wgs, 4096))


# -----------------------------------------------------------------------------
# Paged decode: page-granular LRU replay of a serving tick
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class PagedSimResult:
    """One simulated decode tick over paged KV under a placement policy."""

    policy: str
    hits: int            # page reads served by a domain's cache
    misses: int          # page fills from memory
    hbm_bytes: int
    local_bytes: int     # fills served from the reading domain's own stripe
    remote_bytes: int    # fills crossing the inter-domain fabric
    elapsed: float       # seconds (memory-side roofline w/ link term)

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    @property
    def local_fraction(self) -> float:
        tot = self.local_bytes + self.remote_bytes
        return self.local_bytes / tot if tot else 1.0


def simulate_paged_decode(
    page_tables,
    lengths,
    *,
    num_kv_heads: int,
    page_size: int,
    head_dim: int,
    topo: Topology,
    policy: str = "head_aligned",
    dtype_bytes: int = 2,
    group_size: int = 1,
) -> PagedSimResult:
    """Replay one decode tick: every (sequence, kv head) cell streams its
    live pages through its domain's LRU. The event-level cross-check of
    ``perf_model.estimate_paged_decode`` — it sees what the analytic form
    assumes away: capacity evictions when the shared working set outgrows
    a domain's cache, and the cache-footprint asymmetry of the two
    placement policies (an interleaved shared page lands in every reader
    domain's cache; a head-aligned one in exactly one).
    """
    from repro_torch.cache import layout as layout_lib

    d = max(topo.num_domains, 1)
    page_bytes = 2 * page_size * head_dim * dtype_bytes
    lrus = [_LRU(topo.cache_bytes) for _ in range(d)]
    hits = misses = 0
    local_bytes = remote_bytes = 0
    flops = 0.0
    # Head-first dispatch: cell (b, h) runs in head h's domain. Walk cells
    # batch-innermost (all sequences of one head back to back) — the order
    # the PARALLEL (b, h) grid dims produce within one domain.
    for h in range(num_kv_heads):
        cell_dom = layout_lib.domain_of_head(h, num_kv_heads, d)
        lru = lrus[cell_dom]
        for pages, length in zip(page_tables, lengths):
            live = -(-int(length) // page_size)
            flops += 4.0 * group_size * int(length) * head_dim
            for pid in list(pages)[:live]:
                key = (h, int(pid))
                if lru.touch(key):
                    hits += 1
                    continue
                misses += 1
                lru.insert(key, page_bytes)
                page_dom = layout_lib.domain_of_page(
                    int(pid), h, policy, num_kv_heads, d
                )
                if page_dom == cell_dom:
                    local_bytes += page_bytes
                else:
                    remote_bytes += page_bytes
    hbm_bytes = local_bytes + remote_bytes
    t_mem = hbm_bytes / topo.hbm_bw + remote_bytes / max(topo.link_bw * d, 1.0)
    elapsed = max(flops / topo.peak_flops, t_mem)
    return PagedSimResult(
        policy=policy,
        hits=hits,
        misses=misses,
        hbm_bytes=hbm_bytes,
        local_bytes=local_bytes,
        remote_bytes=remote_bytes,
        elapsed=elapsed,
    )


# -----------------------------------------------------------------------------
# Hierarchical tier: device pool LRU backed by a host page store
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class TieredSimResult:
    """One replayed serving trace over the device↔host KV tier."""

    device_hits: int     # page reads served by the device pool
    promotions: int      # reads served by restoring a demoted host page
    demotions: int       # device-capacity evictions that landed host-side
    recomputes: int      # reads absent from both tiers (prefill again)
    link_bytes: int      # device<->host traffic (both directions)
    hbm_bytes: int       # device fills (promotions + recomputes)
    elapsed: float       # seconds: HBM + host-link + recompute terms

    @property
    def device_hit_rate(self) -> float:
        tot = self.device_hits + self.promotions + self.recomputes
        return self.device_hits / tot if tot else 0.0

    @property
    def rescue_rate(self) -> float:
        """Of the reads that missed the device pool, the fraction the host
        tier rescued from recompute — the number tiering exists to move."""
        cold = self.promotions + self.recomputes
        return self.promotions / cold if cold else 0.0


def simulate_tiered_decode(
    access_trace,
    *,
    page_bytes: int,
    device_pages: int,
    host_pages: int,
    topo: Topology,
    recompute_s_per_page: float,
) -> TieredSimResult:
    """Replay a page-access trace through a two-tier LRU: a device pool of
    ``device_pages`` physical pages in front of a host store of
    ``host_pages``. A device miss checks the host tier: resident pages
    *promote* (one page over the host link, then a device fill); absent
    pages *recompute* (``recompute_s_per_page`` — the extend-prefill cost
    the page's tokens would need). Device-capacity evictions *demote*
    into the host LRU instead of vanishing. This is the event-level
    cross-check of ``perf_model.estimate_tier_transfer`` pricing: it sees
    what the analytic form assumes away — host-LRU churn when the cold
    set outgrows ``host_pages``, and promotion ping-pong when the device
    pool is too small for the live working set.

    ``access_trace``: iterable of hashable page keys in read order (e.g.
    ``(head, pid)`` pairs, or chain hashes from a serving trace)."""
    from repro_torch.core import perf_model

    device: OrderedDict = OrderedDict()
    host: OrderedDict = OrderedDict()
    device_hits = promotions = demotions = recomputes = 0
    link_bytes = hbm_bytes = 0
    for key in access_trace:
        if key in device:
            device.move_to_end(key)
            device_hits += 1
            continue
        if key in host:
            del host[key]
            promotions += 1
            link_bytes += page_bytes
        else:
            recomputes += 1
        hbm_bytes += page_bytes
        device[key] = True
        while len(device) > max(device_pages, 1):
            victim, _ = device.popitem(last=False)
            demotions += 1
            link_bytes += page_bytes
            host[victim] = True
            while len(host) > max(host_pages, 0):
                host.popitem(last=False)
    elapsed = (
        hbm_bytes / topo.hbm_bw
        + link_bytes / perf_model.HOST_LINK_BW
        + recomputes * max(recompute_s_per_page, 0.0)
    )
    return TieredSimResult(
        device_hits=device_hits,
        promotions=promotions,
        demotions=demotions,
        recomputes=recomputes,
        link_bytes=link_bytes,
        hbm_bytes=hbm_bytes,
        elapsed=elapsed,
    )


def compare_mappings(
    workload: AttentionWorkload,
    topo: Topology,
    mappings=swizzle.ALL_MAPPINGS,
    *,
    budget_accesses: int = 3_000_000,
    **kw,
) -> Dict[str, SimResult]:
    max_wgs = kw.pop("max_wgs", None)
    if max_wgs is None:
        max_wgs = default_max_wgs(workload, budget_accesses)
    return {m: simulate(m, workload, topo, max_wgs=max_wgs, **kw) for m in mappings}
