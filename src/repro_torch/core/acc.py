"""Attention Compute Clusters (paper §3.1): the port's copy of
``repro.core.acc``.

An ACC is the set of workgroups that share K/V tensors: one per (batch,
head) under MHA, one per (batch, kv_head) under GQA, spanning
``group_size`` query heads (the Llama-3 family: 8 KV heads). The paper's
target: co-locate every workgroup of an ACC in one NUMA domain, and let
each domain serve one ACC at a time.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.swizzle import AttentionGrid


@dataclasses.dataclass(frozen=True)
class ACCInfo:
    """Footprint of one ACC for cache/bandwidth reasoning."""

    num_wgs: int          # workgroups in the ACC (group_size * blocks_per_head)
    kv_bytes: int         # shared working set: K + V for one kv head
    q_bytes_per_wg: int   # private per-WG operand (one Q row-block)

    def fits_cache(self, cache_bytes: int) -> bool:
        return self.kv_bytes <= cache_bytes


def acc_of(h_q, group_size: int):
    """ACC index of a query head (within one batch element)."""
    return h_q // group_size


def acc_info(grid: AttentionGrid, *, seq_len_kv: int, head_dim: int,
             block_m: int, dtype_bytes: int = 2) -> ACCInfo:
    return ACCInfo(
        num_wgs=grid.group_size * grid.blocks_per_head,
        kv_bytes=2 * seq_len_kv * head_dim * dtype_bytes,
        q_bytes_per_wg=block_m * head_dim * dtype_bytes,
    )


def accs_per_domain(grid: AttentionGrid, num_domains: int) -> float:
    """ACCs each domain must serve over a launch (batch included)."""
    return grid.batch * grid.num_accs / num_domains
