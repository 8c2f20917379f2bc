"""Attention kernels of the paged serving path, with their plain versions.

K1 ``flash_attention.flash_attention_fwd``, K2
``paged_prefill_attention.paged_flash_prefill``, K3/K4
``paged_decode_attention.paged_flash_decode`` (one-pass / split-K). Each
wrapper counts the launches of its CUDA kernel; :func:`launch_counts` reads
them and :func:`reset_launch_counts` sets them to zero.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention, paged_decode_attention, paged_prefill_attention


def launch_counts() -> Dict[str, int]:
    return {
        "flash_attention_fwd": flash_attention.launches,
        "paged_flash_prefill": paged_prefill_attention.launches,
        "paged_flash_decode": paged_decode_attention.launches["one_pass"],
        "paged_flash_decode_split": paged_decode_attention.launches["split"],
    }


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    paged_prefill_attention.launches = 0
    paged_decode_attention.launches["one_pass"] = 0
    paged_decode_attention.launches["split"] = 0
