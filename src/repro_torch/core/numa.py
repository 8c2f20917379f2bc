"""NUMA topology descriptor and the H100 preset.

The JAX package models any accelerator whose compute is partitioned into
*domains* (XCDs on an MI300X, TensorCores on a TPU), each with a private
cache and a number of concurrent execution slots. The port keeps the same
descriptor and adds the one machine it runs on.

What a domain is on an H100: the **streaming multiprocessor**. The split-K
estimator (``core.perf_model.estimate_decode_splits``) asks how many
parallel decode cells the hardware schedules at once; on Hopper a thread
block is dispatched to an SM, not to an L2 half, so occupancy waves are
counted in SMs. The 50 MB L2 is shared by all of them and is where
head-first launch order buys reuse.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Topology:
    """A NUMA-ish accelerator: ``num_domains`` domains that take thread
    blocks independently. The fields are those the split-K estimator reads;
    the JAX package's cache, slot and link fields come with their readers.

    Attributes:
      name: human-readable identifier.
      num_domains: number of domains that take thread blocks independently.
      peak_flops: per-device peak bf16 FLOP/s (all domains combined).
      hbm_bw: per-device memory bandwidth, bytes/s.
    """

    name: str
    num_domains: int
    peak_flops: float
    hbm_bw: float


#: NVIDIA H100 SXM, constants from NVIDIA's data sheet (not measured by
#: this repository): 132 SMs, 989 TFLOP/s dense bf16, 3.35 TB/s HBM3.
H100 = Topology(
    name="h100_sxm",
    num_domains=132,
    peak_flops=989e12,
    hbm_bw=3.35e12,
)
