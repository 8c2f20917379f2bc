"""NUMA topology descriptors: the JAX package's, and two views of the H100.

Port of ``repro.core.numa`` (single-device part). The JAX package models
any accelerator whose compute is partitioned into *domains*, each with a
private cache and ``slots_per_domain`` concurrent execution slots. The same
descriptor drives the cache simulator (``core.cache_sim``), the analytic
mapping model (``core.perf_model.estimate``) that scores the prefill launch
order, the split-K occupancy model (``estimate_decode_splits``) and the
extend / tier estimates the scheduler ranks admissions with.

What a domain is on an H100 depends on the model that reads it, and the
card decided each (``chip_smoke.py``'s plan phase, PERF.md §6):

  * **Occupancy** (split-K waves, extend-prefill occupancy): the
    **streaming multiprocessor**. A decode thread block holds a 128 KiB TMA
    ring, so one runs per SM; the split sweep's measured times step where
    ``cells x splits`` crosses a multiple of 132. Preset :data:`H100`.
  * **Cache view** (the mapping model and the cache simulator): **the
    whole 50 MB L2 as one domain of 132 slots**, preset :data:`H100_L2`.
    The SM's own 256 KiB is ruled out: with it the model reads no reuse and
    prices K1 slower than the card runs it, which needs L2 hits. The two
    25 MB halves are ruled out at B 1, S 8192, where they would make the
    block-first launch 4.6x slower than head-first and the card runs the two
    within a few percent: the halves share what they cache. With one domain
    the paper's swizzled and naive schedules coincide: no Hopper launch
    order keeps an ACC on one side of the chip.

``MeshTopology``, ``mesh_topology`` and ``pod_as_numa`` come with the
distributed slice (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ExtendTerms:
    """The extend estimator's terms for the port's kernels
    (``perf_model.estimate_extend_prefill``), fitted on the card. Both
    routes' attention runs one block per ``tile_rows`` query rows of one
    (b, q head), walking the prefix and the causal tail in tiles of
    ``tile_rows`` keys (K2's grid and K1's are the same: B x Hq x tail
    tiles), so a block's work counts its padded rows and keys.

    Attributes:
      tile_rows: query rows, and keys, of a block's tile (128: ``ptc::BM``
        and ``ptc::BN`` of ``csrc/prefill_tc.cuh``).
      paged_cell_flops: FLOP/s one K2 block sustains.
      paged_launch_s: fixed seconds of a K2 launch.
      gather_cell_flops: FLOP/s one K1 block sustains over the gather
        route's stripe.
      gather_bw: bytes/s of the gather route's copies, charged twice the
        prefix pages' bytes, as the JAX formula charges them.
      gather_s: fixed seconds of the gather route: its copies' launches and
        K1's.
    """

    tile_rows: int
    paged_cell_flops: float
    paged_launch_s: float
    gather_cell_flops: float
    gather_bw: float
    gather_s: float


@dataclasses.dataclass(frozen=True)
class Topology:
    """A NUMA-ish accelerator: ``num_domains`` domains, private caches.

    Attributes (the JAX package's seven, then the split-K terms):
      name: human-readable identifier.
      num_domains: number of NUMA domains (XCDs / TensorCores / SMs / L2).
      slots_per_domain: concurrent workgroup slots per domain.
      cache_bytes: private cache capacity per domain.
      peak_flops: per-device peak bf16 FLOP/s (all domains combined).
      hbm_bw: per-device memory bandwidth, bytes/s.
      link_bw: inter-domain link bandwidth, bytes/s.
      decode_stream_bw: bytes/s one split-K decode cell streams; None = a
        domain's share of ``hbm_bw`` (the JAX package's formula).
      decode_hbm_bw: the aggregate rate that caps a whole decode launch;
        None = ``hbm_bw``.
      decode_wave_s: fixed seconds of each wave of decode cells (a thread
        block's prologue and epilogue); 0 in the JAX package.
      decode_launch_s: fixed seconds of a decode launch, split or not; 0 in
        the JAX package.
      decode_combine_s: fixed seconds of the split path (the combine's
        launch); None = ``perf_model.COMBINE_LAUNCH_OVERHEAD_S``.
      decode_split_s: seconds per split of the combine's walk over the
        partial states; 0 in the JAX package.
      state_rows: rows a GQA group's partial state is padded to (the TPU
        kernels' 8 sublanes; 1 where the kernels do not pad).
      extend: the extend routes' fitted terms (:class:`ExtendTerms`); None
        = the JAX package's formula.
    """

    name: str
    num_domains: int
    slots_per_domain: int
    cache_bytes: int
    peak_flops: float
    hbm_bw: float
    link_bw: float
    decode_stream_bw: Optional[float] = None
    decode_hbm_bw: Optional[float] = None
    decode_wave_s: float = 0.0
    decode_launch_s: float = 0.0
    decode_combine_s: Optional[float] = None
    decode_split_s: float = 0.0
    state_rows: int = 8
    extend: Optional[ExtendTerms] = None

    @property
    def total_slots(self) -> int:
        return self.num_domains * self.slots_per_domain

    @property
    def flops_per_slot(self) -> float:
        return self.peak_flops / self.total_slots

    @property
    def hbm_bw_per_slot(self) -> float:
        return self.hbm_bw / self.total_slots


# --- Presets -----------------------------------------------------------------

#: The paper's evaluation platform (Table 1): 8 XCDs x 38 CUs, 4 MB L2/XCD,
#: 192 GB HBM3 @ 5.3 TB/s, ~1.3 PFLOP/s bf16 peak (MI300X data sheet; the
#: JAX package's preset, copied).
MI300X = Topology(
    name="mi300x",
    num_domains=8,
    slots_per_domain=38,
    cache_bytes=4 * 1024 * 1024,
    peak_flops=1.307e15,
    hbm_bw=5.3e12,
    link_bw=0.75e12,  # per-XCD Infinity-Fabric share (estimate)
)

#: NVIDIA H100 SXM, occupancy view: one domain per SM. Data-sheet constants
#: (not measured by this repository): 132 SMs, 256 KiB of L1 / shared
#: memory each, 989 TFLOP/s dense bf16, 3.35 TB/s HBM3; ``link_bw`` is an
#: SM's share of the memory rate (an SM reaches other SMs' data only
#: through the L2 and memory). The decode_* terms are fitted by
#: ``chip_smoke.py``'s plan phase (a) (with ``perf_model``'s
#: ``COMBINE_LAUNCH_OVERHEAD_S``) to 59 one-launch CUDA-graph replays of
#: bf16 K3 / K4 at llama3-8b widths (Hq 32, Hkv 8, D 128, page 16, every
#: row full, queue primed, L2 flushed): B 1, 2, 4 at 128 pages, B 1, 4, 8
#: at 256 and B 8 at 36, split counts 1, 2, 3, 4, 6, 8, 12, 16 and the
#: plan's pick; rms error 7.1%, on an NVIDIA H100 80GB HBM3 at a 700 W
#: power limit. A decode CTA streams ~46 GB/s; a launch tops out at ~2.1
#: TB/s. The extend terms are fitted by ``chip_smoke.py``'s plan part (d) to
#: K2, and to the gather route's copies and K1, at 8 llama3-8b (rows,
#: prefix, tail) shapes (bf16, page 16, L2 flushed, queue primed; 3 more
#: held out), on the same card: a K2 block sustains ~3.1 TFLOP/s and a K1
#: block ~3.6 over their padded 128-row tiles; the gather's copies move
#: ~0.15 TB/s of prefix pages.
H100 = Topology(
    name="h100_sxm",
    num_domains=132,
    slots_per_domain=1,
    cache_bytes=256 * 1024,
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=3.35e12 / 132,
    decode_stream_bw=45.87e9,
    decode_hbm_bw=2.086e12,
    decode_wave_s=3.25e-6,
    decode_launch_s=8.9e-6,
    decode_split_s=0.4005e-6,
    state_rows=1,
    extend=ExtendTerms(tile_rows=128, paged_cell_flops=3.055e12, paged_launch_s=13.16e-6,
                       gather_cell_flops=3.634e12, gather_bw=0.2976e12, gather_s=50.87e-6),
)

#: NVIDIA H100 SXM for the dense decode kernels (K7/K8), whose split terms
#: are not fitted: :data:`H100`'s data-sheet constants under the JAX
#: package's formula (a domain's share of 3.35 TB/s per cell, no wave or
#: launch cost), the group unpadded, and the split path's fixed cost of the
#: eager decode call (17 us, host clock per call over back-to-back calls of
#: the paged decode wrapper, on an NVIDIA H100 80GB HBM3 at a 700 W power
#: limit). It keeps the split choices the card measured right at the
#: dense serve shapes (PERF.md §6, K7/K8 rows).
H100_DENSE_DECODE = dataclasses.replace(
    H100, name="h100_sxm_dense_decode", decode_stream_bw=None, decode_hbm_bw=None,
    decode_wave_s=0.0, decode_launch_s=0.0, decode_combine_s=17e-6, decode_split_s=0.0)

#: NVIDIA H100 SXM, cache view: the whole 50 MB L2 as one domain of 132
#: slots (see the module docstring). Data-sheet constants, as :data:`H100`.
H100_L2 = Topology(
    name="h100_sxm_l2",
    num_domains=1,
    slots_per_domain=132,
    cache_bytes=50 * 1024 * 1024,
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=3.35e12,
)
