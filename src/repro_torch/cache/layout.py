"""Page placement policy and split-K page ranges.

The port's copy of what the paged kernels need from ``repro.cache.layout``:
the head-major pool (``HEAD_ALIGNED``: all pages of one KV head contiguous,
``(Hkv, num_pages, page_size, D)``) and :func:`decode_split_ranges`, the one
source of truth for split-K boundaries that the plain path, the CUDA
wrapper and the tests all replay; and the domain arithmetic the cache
simulator replays page reads with (:func:`domain_of_head`,
:func:`domain_of_page`; ``INTERLEAVED`` exists there only, as the naive
placement the simulator compares against).
"""

from __future__ import annotations

from typing import Tuple

HEAD_ALIGNED = "head_aligned"
INTERLEAVED = "interleaved"


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
