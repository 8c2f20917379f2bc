"""Page placement policy, split-K page ranges and the modelled traffic of a
paged decode tick.

The port's copy of ``repro.cache.layout`` (single-device part). The pool is
head-major (``HEAD_ALIGNED``: all pages of one KV head contiguous,
``(Hkv, num_pages, page_size, D)``), so every page a (batch, kv head) cell
reads lives in the domain that runs the cell. ``INTERLEAVED`` (pages handed
out round-robin over domains whatever their head) is the naive placement
the models compare against; the port's pool never uses it.

  * :func:`decode_split_ranges`: the one source of truth for split-K
    boundaries that the plain path, the CUDA wrapper and the tests replay;
    :func:`split_ranges_domain_aligned` says whether each range reads one
    domain.
  * :func:`domain_of_head`, :func:`domain_of_page`: the domain arithmetic
    the cache simulator and the traffic model share.
  * :func:`decode_page_traffic` / :func:`compare_policies`: the paper's
    page-placement A/B. One decode tick over real or synthetic page tables
    under either policy, local and remote bytes, with a (domain, head,
    page) fetched once a tick, so pages shared by a prefix pay once.

``device_of_head`` comes with the distributed slice (ROADMAP Queue A
item 6).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Sequence, Tuple

if TYPE_CHECKING:
    from repro_torch.core.numa import Topology

HEAD_ALIGNED = "head_aligned"
INTERLEAVED = "interleaved"

PAGE_POLICIES = (HEAD_ALIGNED, INTERLEAVED)


def decode_split_ranges(
    num_units: int, num_splits: int
) -> Tuple[Tuple[int, int], ...]:
    """Partition a decode cell's walk of ``num_units`` pages into
    ``num_splits`` contiguous half-open ``(start, end)`` ranges.

    Ranges are equal-width (``ceil(num_units / num_splits)``) except the
    trailing one, which may be short; ranges that would be empty are
    dropped, so the returned count can be below ``num_splits`` (5 units over
    4 requested splits give 2+2+1). Boundaries are page-granular, so a
    split never bisects a page.
    """
    if num_units <= 0:
        return ((0, 0),)
    s = max(1, min(int(num_splits), int(num_units)))
    per = -(-num_units // s)
    s = -(-num_units // per)  # drop empty trailing ranges
    return tuple(
        (i * per, min((i + 1) * per, num_units))
        for i in range(s)
    )


def split_ranges_domain_aligned(ranges: Sequence[Tuple[int, int]], *, head: int,
                                policy: str, num_kv_heads: int, num_domains: int) -> bool:
    """True iff every page range reads from one memory domain for ``head``
    under ``policy``: each split's partial pass then stays inside one
    domain's cache. Always under ``HEAD_ALIGNED``; under ``INTERLEAVED``
    never for a multi-page range when ``num_domains > 1``."""
    for start, end in ranges:
        domains = {domain_of_page(pid, head, policy, num_kv_heads, num_domains)
                   for pid in range(start, end)}
        if len(domains) > 1:
            return False
    return True


def domain_of_head(head: int, num_kv_heads: int, num_domains: int) -> int:
    """Domain owning a KV head: contiguous head blocks (the head-first
    grid's split of heads over domains)."""
    if num_kv_heads >= num_domains:
        return head * num_domains // num_kv_heads
    return head % num_domains


def domain_of_page(pid: int, head: int, policy: str, num_kv_heads: int,
                   num_domains: int) -> int:
    """Memory domain holding physical page ``pid`` of head ``head``."""
    if policy == HEAD_ALIGNED:
        return domain_of_head(head, num_kv_heads, num_domains)
    if policy == INTERLEAVED:
        return pid % num_domains
    raise ValueError(f"unknown page placement policy {policy!r}")


@dataclasses.dataclass(frozen=True)
class PagedTraffic:
    """Modelled bytes of one decode tick over paged KV."""

    policy: str
    total_bytes: int     # all K/V bytes the cells request
    local_bytes: int     # served from the cell's own domain
    remote_bytes: int    # crossed the inter-domain link
    unique_bytes: int    # after once-per-(domain, head, page) coalescing
    reuse_hits: int      # page fetches saved by sharing within the tick
    page_fetches: int    # unique (domain, head, page) fills

    @property
    def local_fraction(self) -> float:
        return self.local_bytes / self.total_bytes if self.total_bytes else 1.0

    @property
    def reuse_rate(self) -> float:
        total = self.reuse_hits + self.page_fetches
        return self.reuse_hits / total if total else 0.0

    def time(self, topo: "Topology") -> float:
        """Memory-side seconds of the tick: unique bytes over the memory
        rate, and their remote share again over the domains' links."""
        t_hbm = self.unique_bytes / topo.hbm_bw
        remote_unique = self.unique_bytes * (
            self.remote_bytes / self.total_bytes if self.total_bytes else 0.0)
        t_link = remote_unique / max(topo.link_bw * topo.num_domains, 1.0)
        return t_hbm + t_link


def decode_page_traffic(page_tables: Sequence[Sequence[int]], lengths: Sequence[int], *,
                        num_kv_heads: int, page_size: int, head_dim: int,
                        topo: "Topology", policy: str = HEAD_ALIGNED,
                        dtype_bytes: int = 2) -> PagedTraffic:
    """Charge one decode tick: every (sequence, kv head) cell walks its live
    pages. A (domain, head, page) triple is fetched once a tick (later
    readers hit the domain's cache): that is where prefix-shared pages pay
    off, and only ``HEAD_ALIGNED`` keeps them in one domain."""
    page_bytes = 2 * page_size * head_dim * dtype_bytes  # K and V
    seen = set()
    total = local = unique = 0
    reuse_hits = 0
    for pages, length in zip(page_tables, lengths):
        live = -(-int(length) // page_size)
        for h in range(num_kv_heads):
            cell_dom = domain_of_head(h, num_kv_heads, topo.num_domains)
            for pid in list(pages)[:live]:
                page_dom = domain_of_page(int(pid), h, policy, num_kv_heads,
                                          topo.num_domains)
                total += page_bytes
                if page_dom == cell_dom:
                    local += page_bytes
                key = (cell_dom, h, int(pid))
                if key in seen:
                    reuse_hits += 1
                else:
                    seen.add(key)
                    unique += page_bytes
    return PagedTraffic(policy=policy, total_bytes=total, local_bytes=local,
                        remote_bytes=total - local, unique_bytes=unique,
                        reuse_hits=reuse_hits, page_fetches=len(seen))


def compare_policies(page_tables: Sequence[Sequence[int]], lengths: Sequence[int], *,
                     num_kv_heads: int, page_size: int, head_dim: int, topo: "Topology",
                     dtype_bytes: int = 2) -> Dict[str, PagedTraffic]:
    """Both placement policies over the same tick (the A/B)."""
    return {policy: decode_page_traffic(page_tables, lengths, num_kv_heads=num_kv_heads,
                                        page_size=page_size, head_dim=head_dim, topo=topo,
                                        policy=policy, dtype_bytes=dtype_bytes)
            for policy in PAGE_POLICIES}
