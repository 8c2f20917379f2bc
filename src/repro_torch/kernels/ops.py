"""Attention entry points: plan-driven dispatch and padding.

Port of ``repro.kernels.ops``. Every op takes an :class:`AttentionPlan`
(built here when none is passed) and dispatches on ``plan.impl``:

  * ``"cuda"`` — the kernel wrappers (``flash_attention_fwd``,
    ``paged_flash_prefill``, ``paged_flash_decode``), which launch the
    hand-written kernels on CUDA tensors;
  * ``"plain"`` — the plain PyTorch version beside each kernel, on any
    device (the CPU path, and the reference the card compares against).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.flash_attention import (
    BLOCK_M,
    BLOCK_N,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from repro_torch.kernels.paged_decode_attention import (
    paged_flash_decode,
    paged_flash_decode_plain,
)
from repro_torch.kernels.paged_prefill_attention import (
    paged_flash_prefill,
    paged_flash_prefill_plain,
)
from repro_torch.kernels.plan import AttentionPlan, plan_attention


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, plan: Optional[AttentionPlan] = None) -> torch.Tensor:
    """GQA attention. q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D).

    The kernel path pads Sq and Skv to the block sizes and masks the padded
    keys with ``kv_len``, as ``repro.kernels.ops`` does for Pallas."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if plan is None:
        plan = plan_attention((b, hq, k.shape[1], sq, skv, d),
                              phase=plan_lib.PREFILL, window=window,
                              device_type=q.device.type,
                              dtype_bytes=q.element_size())
    if plan.impl == "plain":
        return flash_attention_fwd_plain(q, k, v, causal=causal, window=window,
                                         softcap=softcap, scale=scale)[0]
    qp = _pad_to(q, 2, BLOCK_M).contiguous()
    kp = _pad_to(k, 2, BLOCK_N).contiguous()
    vp = _pad_to(v, 2, BLOCK_N).contiguous()
    o, _ = flash_attention_fwd(qp, kp, vp, mapping=plan.mapping, causal=causal,
                               window=window, softcap=softcap, scale=scale,
                               kv_len=skv)
    return o[:, :, :sq]


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           softcap=None, scale=None, window=None,
                           plan: Optional[AttentionPlan] = None) -> torch.Tensor:
    """Paged single-token decode. q (B, Hq, D); k/v_pages (Hkv, P, ps, D);
    page_table (B, max_pages) int32; lengths (B,) int32."""
    b, hq, d = q.shape
    hkv, _, ps, _ = k_pages.shape
    if plan is None:
        plan = plan_attention((b, hq, hkv, 1, page_table.shape[1] * ps, d),
                              phase=plan_lib.DECODE, kv_layout=plan_lib.PAGED,
                              page_size=ps, window=window,
                              device_type=q.device.type,
                              dtype_bytes=k_pages.element_size())
    fn = paged_flash_decode_plain if plan.impl == "plain" else paged_flash_decode
    return fn(q, k_pages, v_pages, page_table, lengths, softcap=softcap,
              scale=scale, window=window, num_splits=plan.num_splits)


def paged_prefill_attention(q, k_pages, v_pages, page_table, k_tail, v_tail,
                            prefix_len, tail_len, *, softcap=None, scale=None,
                            window=None, plan: Optional[AttentionPlan] = None
                            ) -> torch.Tensor:
    """Prefix-extension prefill over paged prefix K/V. q (B, Hq, St, D);
    page_table (B, prefix_pages) int32; k/v_tail (B, Hkv, St, D);
    prefix_len / tail_len (B,) int32."""
    b, hq, st, d = q.shape
    hkv, _, ps, _ = k_pages.shape
    if plan is None:
        plan = plan_attention(
            (b, hq, hkv, st, page_table.shape[1] * ps + st, d),
            phase=plan_lib.EXTEND, kv_layout=plan_lib.PAGED, page_size=ps,
            window=window, device_type=q.device.type, dtype_bytes=q.element_size())
    fn = paged_flash_prefill_plain if plan.impl == "plain" else paged_flash_prefill
    return fn(q.contiguous(), k_pages, v_pages, page_table, k_tail.contiguous(),
              v_tail.contiguous(), prefix_len, tail_len, softcap=softcap,
              scale=scale, window=window)
