"""Kernels of the serving and training paths, with their plain versions.

K1 ``flash_attention.flash_attention_fwd`` (``flash_attention_fwd_tc``
counts its bf16 tensor-core launches alone), K5/K6
``flash_attention_bwd.flash_attention_bwd`` (dQ / dK-dV), K2
``paged_prefill_attention.paged_flash_prefill``, K3/K4
``paged_decode_attention.paged_flash_decode`` (one-pass / split-K), K7/K8
``decode_attention.flash_decode`` (dense one-pass / split-K) and K9
``ssd.ssd_intra_chunk`` (the Mamba-2 SSD intra-chunk block). Each wrapper
counts the launches of its CUDA kernel; :func:`launch_counts` reads them
and :func:`reset_launch_counts` sets them to zero.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import (
    decode_attention,
    flash_attention,
    flash_attention_bwd,
    paged_decode_attention,
    paged_prefill_attention,
    ssd,
)


def launch_counts() -> Dict[str, int]:
    return {
        "flash_attention_fwd": flash_attention.launches,
        "flash_attention_fwd_tc": flash_attention.launches_tc,
        "flash_attention_bwd_dq": flash_attention_bwd.launches["dq"],
        "flash_attention_bwd_dkv": flash_attention_bwd.launches["dkv"],
        "paged_flash_prefill": paged_prefill_attention.launches,
        "paged_flash_decode": paged_decode_attention.launches["one_pass"],
        "paged_flash_decode_split": paged_decode_attention.launches["split"],
        "flash_decode": decode_attention.launches["one_pass"],
        "flash_decode_split": decode_attention.launches["split"],
        "ssd_intra_chunk": ssd.launches,
    }


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.launches_tc = 0
    flash_attention_bwd.launches["dq"] = 0
    flash_attention_bwd.launches["dkv"] = 0
    paged_prefill_attention.launches = 0
    paged_decode_attention.launches["one_pass"] = 0
    paged_decode_attention.launches["split"] = 0
    decode_attention.launches["one_pass"] = 0
    decode_attention.launches["split"] = 0
    ssd.launches = 0
