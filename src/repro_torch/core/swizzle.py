"""Workgroup-ID swizzling (the paper's core contribution, Figs. 7-11) and
the KV-tile traversal order: the port's copy of ``repro.core.swizzle``.

A FlashAttention-2 launch is a 1-D grid of ``batch * num_q_heads *
blocks_per_head`` workgroups. The hardware dispatches workgroup ``wid`` to
domain ``wid % num_domains``; a *mapping strategy* decides which ``(batch,
q_head, q_block)`` cell a given ``wid`` executes. The four strategies of
paper §3.2-3.3: ``naive_block_first``, ``swizzled_block_first``,
``naive_head_first`` and ``swizzled_head_first``. All functions are pure
``//``, ``%``, ``*`` arithmetic, so they evaluate identically on Python ints
and numpy arrays; they feed the cache simulator and the analytic model
(``core.perf_model.estimate``) that the plan scores launches with.

On Hopper a CTA's ``blockIdx`` decodes into one of two orders
(``kernels.flash_attention``), and the four names are aliases of them.

``linear`` walks a sweep's KV tiles in ascending order every time;
``sawtooth`` reverses odd sweeps, so consecutive sweeps meet at a shared
boundary tile. The CUDA prefill kernel computes the same index
(``csrc/flash_attention.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

NAIVE_BLOCK_FIRST = "naive_block_first"
SWIZZLED_BLOCK_FIRST = "swizzled_block_first"
NAIVE_HEAD_FIRST = "naive_head_first"
SWIZZLED_HEAD_FIRST = "swizzled_head_first"

ALL_MAPPINGS = (
    NAIVE_BLOCK_FIRST,
    SWIZZLED_BLOCK_FIRST,
    NAIVE_HEAD_FIRST,
    SWIZZLED_HEAD_FIRST,
)

LINEAR = "linear"
SAWTOOTH = "sawtooth"
TRAVERSALS = (LINEAR, SAWTOOTH)


def kv_tile_order(traversal: str, sweep, n, num_n: int):
    """Effective KV tile index for step ``n`` of sweep ``sweep``."""
    if traversal == LINEAR:
        return n
    if traversal != SAWTOOTH:
        raise ValueError(f"unknown traversal {traversal!r}")
    rev = sweep % 2
    return (1 - rev) * n + rev * (num_n - 1 - n)


@dataclasses.dataclass(frozen=True)
class AttentionGrid:
    """Shape of the FA2 workgroup grid for one kernel launch. An Attention
    Compute Cluster (ACC, paper §3.1) is the set of workgroups sharing a KV
    tensor: ``group_size * blocks_per_head`` per (batch, kv_head)."""

    batch: int
    num_q_heads: int
    blocks_per_head: int
    group_size: int = 1

    def __post_init__(self):
        if self.num_q_heads % self.group_size:
            raise ValueError(
                f"num_q_heads={self.num_q_heads} not divisible by "
                f"group_size={self.group_size}"
            )

    @property
    def num_kv_heads(self) -> int:
        return self.num_q_heads // self.group_size

    @property
    def wgs_per_batch(self) -> int:
        return self.num_q_heads * self.blocks_per_head

    @property
    def total_wgs(self) -> int:
        return self.batch * self.wgs_per_batch

    @property
    def num_accs(self) -> int:
        """ACCs per batch element: one per KV head."""
        return self.num_kv_heads


def domain_of(wid, num_domains: int):
    """Hardware dispatch policy: chunked round-robin with chunk size 1."""
    return wid % num_domains


def _heads_per_domain(num_q_heads: int, num_domains: int) -> int:
    """The paper assumes H % D == 0; round up and wrap for the general case."""
    return max(1, -(-num_q_heads // num_domains))


def decode(mapping: str, wid, grid: AttentionGrid, num_domains: int):
    """Map a linear workgroup id to its ``(batch, q_head, q_block)`` cell."""
    wpb = grid.wgs_per_batch
    b = wid // wpb
    r = wid % wpb
    h_count = grid.num_q_heads
    m_count = grid.blocks_per_head
    d = num_domains

    if mapping == NAIVE_BLOCK_FIRST:
        h = r % h_count
        m = r // h_count
    elif mapping == SWIZZLED_BLOCK_FIRST:
        # Domain d serves heads [d*hpx, (d+1)*hpx), block-first across them.
        hpx = _heads_per_domain(h_count, d)
        dom = r % d
        slot = r // d
        h = (dom * hpx + slot % hpx) % h_count
        m = (slot // hpx) % m_count
    elif mapping == NAIVE_HEAD_FIRST:
        h = r // m_count
        m = r % m_count
    elif mapping == SWIZZLED_HEAD_FIRST:
        # Paper Fig. 11: domain d serves heads [d*hpx, (d+1)*hpx) one full
        # head at a time, blocks in order within the head.
        hpx = _heads_per_domain(h_count, d)
        dom = r % d
        h = (dom * hpx + r // (d * m_count)) % h_count
        m = (r % (d * m_count)) // d
    else:
        raise ValueError(f"unknown mapping {mapping!r}")
    return b, h, m


def encode(mapping: str, b, h, m, grid: AttentionGrid, num_domains: int):
    """Inverse of :func:`decode` (exists when H % D == 0)."""
    wpb = grid.wgs_per_batch
    h_count = grid.num_q_heads
    m_count = grid.blocks_per_head
    d = num_domains

    if mapping == NAIVE_BLOCK_FIRST:
        r = m * h_count + h
    elif mapping == SWIZZLED_BLOCK_FIRST:
        hpx = _heads_per_domain(h_count, d)
        dom = h // hpx
        slot = m * hpx + h % hpx
        r = slot * d + dom
    elif mapping == NAIVE_HEAD_FIRST:
        r = h * m_count + m
    elif mapping == SWIZZLED_HEAD_FIRST:
        hpx = _heads_per_domain(h_count, d)
        dom = h // hpx
        r = (h % hpx) * (d * m_count) + m * d + dom
    else:
        raise ValueError(f"unknown mapping {mapping!r}")
    return b * wpb + r


def heads_per_domain_sets(mapping: str, grid: AttentionGrid,
                          num_domains: int) -> Tuple[set, ...]:
    """Which q-heads each domain touches (batch 0). Under
    ``swizzled_head_first`` each domain's set is a contiguous range of
    ``H/D`` heads: whole ACCs."""
    wids = np.arange(grid.wgs_per_batch)
    _, h, _ = decode(mapping, wids, grid, num_domains)
    doms = domain_of(wids, num_domains)
    return tuple(
        set(np.unique(h[doms == dom]).tolist()) for dom in range(num_domains)
    )


def accs_per_domain_concurrent(mapping: str, grid: AttentionGrid,
                               num_domains: int, window: int) -> float:
    """Mean number of *distinct ACCs* live in a domain's dispatch window of
    ``window`` concurrently resident workgroups: 1 means one shared KV
    stream (hits), ``window`` means thrash (the paper's L2 argument)."""
    wids = np.arange(grid.total_wgs)
    b, h, _ = decode(mapping, wids, grid, num_domains)
    doms = domain_of(wids, num_domains)
    acc = b * grid.num_kv_heads + h // grid.group_size
    counts = []
    for dom in range(num_domains):
        stream = acc[doms == dom]
        for i in range(0, len(stream) - window + 1, window):
            counts.append(len(np.unique(stream[i : i + window])))
    return float(np.mean(counts)) if counts else 0.0
