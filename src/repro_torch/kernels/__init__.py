"""Kernels of the serving and training paths, with their plain versions.

K1 ``flash_attention.flash_attention_fwd`` (``flash_attention_fwd_tc``
counts its bf16 tensor-core launches alone), K5/K6
``flash_attention_bwd.flash_attention_bwd`` (dQ / dK-dV; the ``_tc``
counters likewise, the ``_tf32`` ones its float32 launches, on the tensor
cores in 3xTF32), K2
``paged_prefill_attention.paged_flash_prefill`` (``paged_flash_prefill_tc``
counts its bf16 tensor-core launches alone, ``paged_flash_prefill_q`` its
launches over a quantized pool, which the other two do not count, and
``paged_flash_prefill_q_tc`` those of them on the tensor cores, with bf16
q, alone), K3/K4
``paged_decode_attention.paged_flash_decode`` (one-pass / split-K;
``paged_flash_decode_tc`` and ``paged_flash_decode_split_tc`` count the
bf16 tensor-core launches alone; ``paged_flash_decode_q`` and
``paged_flash_decode_split_q`` the launches over a quantized pool, which
the others do not count, and ``paged_flash_decode_q_tc`` and
``paged_flash_decode_split_q_tc`` those of them on the tensor cores, with
bf16 q, alone), K7/K8
``decode_attention.flash_decode`` (dense one-pass / split-K;
``flash_decode_tc`` and ``flash_decode_split_tc`` count the bf16
tensor-core launches alone) and K9
``ssd.ssd_intra_chunk`` / ``ssd.ssd_intra_chunk_seq`` (the Mamba-2 SSD
intra-chunk block, one kernel on the tensor cores in 3xTF32 for every
call: ``ssd_intra_chunk_tc``). Each wrapper
counts the launches of its CUDA kernel; :func:`launch_counts` reads them,
:func:`reset_launch_counts` sets them to zero and
:func:`add_launch_counts` adds what a CUDA graph's replay launched.
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


#: Counter name -> (module, attribute, key of a dict attribute or None).
_COUNTERS = {
    "flash_attention_fwd": (flash_attention, "launches", None),
    "flash_attention_fwd_tc": (flash_attention, "launches_tc", None),
    "flash_attention_bwd_dq": (flash_attention_bwd, "launches", "dq"),
    "flash_attention_bwd_dkv": (flash_attention_bwd, "launches", "dkv"),
    "flash_attention_bwd_dq_tc": (flash_attention_bwd, "launches", "dq_tc"),
    "flash_attention_bwd_dkv_tc": (flash_attention_bwd, "launches", "dkv_tc"),
    "flash_attention_bwd_dq_tf32": (flash_attention_bwd, "launches", "dq_tf32"),
    "flash_attention_bwd_dkv_tf32": (flash_attention_bwd, "launches", "dkv_tf32"),
    "paged_flash_prefill": (paged_prefill_attention, "launches", None),
    "paged_flash_prefill_tc": (paged_prefill_attention, "launches_tc", None),
    "paged_flash_prefill_q": (paged_prefill_attention, "launches_q", None),
    "paged_flash_prefill_q_tc": (paged_prefill_attention, "launches_q_tc", None),
    "paged_flash_decode": (paged_decode_attention, "launches", "one_pass"),
    "paged_flash_decode_split": (paged_decode_attention, "launches", "split"),
    "paged_flash_decode_tc": (paged_decode_attention, "launches", "one_pass_tc"),
    "paged_flash_decode_split_tc": (paged_decode_attention, "launches", "split_tc"),
    "paged_flash_decode_q": (paged_decode_attention, "launches", "one_pass_q"),
    "paged_flash_decode_split_q": (paged_decode_attention, "launches", "split_q"),
    "paged_flash_decode_q_tc": (paged_decode_attention, "launches", "one_pass_q_tc"),
    "paged_flash_decode_split_q_tc": (paged_decode_attention, "launches", "split_q_tc"),
    "flash_decode": (decode_attention, "launches", "one_pass"),
    "flash_decode_split": (decode_attention, "launches", "split"),
    "flash_decode_tc": (decode_attention, "launches", "one_pass_tc"),
    "flash_decode_split_tc": (decode_attention, "launches", "split_tc"),
    "ssd_intra_chunk_tc": (ssd, "launches", None),
}


def _read(module, attr, key) -> int:
    value = getattr(module, attr)
    return value if key is None else value[key]


def launch_counts() -> Dict[str, int]:
    return {name: _read(*spec) for name, spec in _COUNTERS.items()}


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` to the counters: a CUDA graph's replay launches what
    its capture recorded, and the wrappers do not run at a replay."""
    for name, n in delta.items():
        module, attr, key = _COUNTERS[name]
        if key is None:
            setattr(module, attr, getattr(module, attr) + n)
        else:
            getattr(module, attr)[key] += n


def reset_launch_counts() -> None:
    add_launch_counts({name: -n for name, n in launch_counts().items()})
