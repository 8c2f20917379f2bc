"""Attention entry points: plan-driven dispatch and padding.

Port of ``repro.kernels.ops``. Every op takes an :class:`AttentionPlan`
(built here when none is passed) and dispatches on ``plan.impl``:

  * ``"cuda"`` — the kernel wrappers (``flash_attention_fwd``,
    ``paged_flash_prefill``, ``paged_flash_decode``, ``flash_decode``),
    which launch the hand-written kernels on CUDA tensors;
  * ``"plain"`` — the plain PyTorch version beside each kernel, on any
    device (the CPU path, and the reference the card compares against);
  * ``"gather"`` (paged extend only) — the prefix gathered to dense
    stripes, then K1 with per-row query offsets
    (``paged_prefill_attention.paged_prefill_gather``; K1's plain version
    on CPU tensors).

``flash_attention`` is differentiable: when grad mode is on and an input
needs a gradient it runs :class:`_FlashAttention`, the counterpart of the
JAX package's ``_pallas_attention`` and its ``custom_vjp``: K1 forward,
K5 and K6 backward (or the plain versions of all three for ``"plain"``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.decode_attention import flash_decode, flash_decode_plain
from repro_torch.kernels.flash_attention import (
    BLOCK_M,
    BLOCK_N,
    MappingConfig,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from repro_torch.kernels.paged_decode_attention import (
    paged_flash_decode,
    paged_flash_decode_plain,
)
from repro_torch.kernels.paged_prefill_attention import (
    paged_flash_prefill,
    paged_flash_prefill_plain,
    paged_prefill_gather,
)
from repro_torch.kernels.plan import AttentionPlan, plan_attention


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


class _FlashAttention(torch.autograd.Function):
    """FA2 with its backward kernels: saves (q, k, v, o, lse) in forward
    and runs K5 / K6 (``flash_attention_bwd``) in backward. ``impl ==
    "plain"`` runs the plain versions of the three kernels instead; CPU
    tensors take the plain versions through the wrappers either way."""

    @staticmethod
    def forward(ctx, q, k, v, impl: str, mapping: MappingConfig, causal, window,
                softcap, scale, kv_len):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                  kv_len=kv_len)
        if impl == "plain":
            o, lse = flash_attention_fwd_plain(q, k, v, **kw)
        else:
            o, lse = flash_attention_fwd(q, k, v, mapping=mapping, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.impl, ctx.mapping, ctx.kw = impl, mapping, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if ctx.impl == "plain":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, **ctx.kw)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, mapping=ctx.mapping,
                                             **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, q_offset: int = 0,
                    plan: Optional[AttentionPlan] = None) -> torch.Tensor:
    """GQA attention. q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D).

    ``q_offset`` places the queries at positions ``[q_offset, q_offset +
    Sq)`` against a longer K/V: the dense extend (phase ``EXTEND``), K1
    with the offset on the card. It has no gradient yet: K5 / K6 take no
    offset, so with grad mode on and an input that needs a gradient a
    nonzero offset raises.

    The kernel path pads Sq and Skv to the block sizes and masks the padded
    keys with ``kv_len``, as ``repro.kernels.ops`` does for Pallas. With
    grad mode on and an input that needs a gradient, both paths run
    :class:`_FlashAttention` on the padded tensors: the ``kv_len`` mask gives
    padded keys a zero dK / dV, and the slice back to ``Sq`` gives padded
    query rows a zero dO."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if plan is None:
        plan = plan_attention((b, hq, k.shape[1], sq, skv, d),
                              phase=plan_lib.EXTEND if q_offset else plan_lib.PREFILL,
                              window=window, device_type=q.device.type,
                              dtype_bytes=q.element_size())
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if grad and q_offset:
        raise NotImplementedError(
            "flash_attention(q_offset=) has no backward yet: K5 / K6 take no query "
            "offset (ROADMAP.md, Queue A)")
    if plan.impl == "plain" and not grad:
        return flash_attention_fwd_plain(q, k, v, causal=causal, window=window,
                                         softcap=softcap, scale=scale,
                                         q_offset=q_offset)[0]
    qp = _pad_to(q, 2, BLOCK_M).contiguous()
    kp = _pad_to(k, 2, BLOCK_N).contiguous()
    vp = _pad_to(v, 2, BLOCK_N).contiguous()
    if grad:
        o = _FlashAttention.apply(qp, kp, vp, plan.impl, plan.mapping, causal,
                                  window, softcap, scale, skv)
    else:
        o, _ = flash_attention_fwd(qp, kp, vp, mapping=plan.mapping, causal=causal,
                                   window=window, softcap=softcap, scale=scale,
                                   kv_len=skv, q_offset=q_offset)
    return o[:, :, :sq]


def decode_attention(q, k_cache, v_cache, lengths, *, softcap=None, scale=None,
                     window=None, plan: Optional[AttentionPlan] = None) -> torch.Tensor:
    """Dense single-token decode. q (B, Hq, D); caches (B, Hkv, Smax, D);
    lengths (B,) int32.

    The KV chunk and ``num_splits`` ride the plan. Only a capacity that
    the chunk does not divide pays the pad-to-chunk copy; the padded tail
    sits past every ``lengths`` entry, so masking never admits it."""
    b, hq, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    if plan is None:
        plan = plan_attention((b, hq, hkv, 1, smax, d), phase=plan_lib.DECODE,
                              kv_layout=plan_lib.DENSE, window=window,
                              device_type=q.device.type,
                              dtype_bytes=k_cache.element_size())
    chunk = min(plan.chunk or smax, smax)
    if smax % chunk:
        k_cache = _pad_to(k_cache, 2, chunk)
        v_cache = _pad_to(v_cache, 2, chunk)
    fn = flash_decode_plain if plan.impl == "plain" else flash_decode
    return fn(q, k_cache, v_cache, lengths, softcap=softcap, scale=scale, window=window,
              chunk=chunk, num_splits=plan.num_splits)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           softcap=None, scale=None, window=None,
                           plan: Optional[AttentionPlan] = None, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """Paged single-token decode. q (B, Hq, D); k/v_pages (Hkv, P, ps, D);
    page_table (B, max_pages) int32; lengths (B,) int32; ``k_scales`` /
    ``v_scales`` (Hkv, P) float32 for a quantized pool."""
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
              scale=scale, window=window, num_splits=plan.num_splits,
              k_scales=k_scales, v_scales=v_scales)


def paged_prefill_attention(q, k_pages, v_pages, page_table, k_tail, v_tail,
                            prefix_len, tail_len, *, softcap=None, scale=None,
                            window=None, plan: Optional[AttentionPlan] = None,
                            k_scales=None, v_scales=None) -> torch.Tensor:
    """Prefix-extension prefill over paged prefix K/V. q (B, Hq, St, D);
    page_table (B, prefix_pages) int32; k/v_tail (B, Hkv, St, D);
    prefix_len / tail_len (B,) int32; ``k_scales`` / ``v_scales`` (Hkv, P)
    float32 for a quantized pool. The plan's impl picks the route: K2
    (``"cuda"``), its plain version (``"plain"``) or the gather route
    (``"gather"``)."""
    b, hq, st, d = q.shape
    hkv, _, ps, _ = k_pages.shape
    if plan is None:
        plan = plan_attention(
            (b, hq, hkv, st, page_table.shape[1] * ps + st, d),
            phase=plan_lib.EXTEND, kv_layout=plan_lib.PAGED, page_size=ps,
            prefix_pages=page_table.shape[1], window=window,
            device_type=q.device.type, dtype_bytes=q.element_size())
    fn = {"plain": paged_flash_prefill_plain,
          plan_lib.GATHER: paged_prefill_gather}.get(plan.impl, paged_flash_prefill)
    return fn(q.contiguous(), k_pages, v_pages, page_table, k_tail.contiguous(),
              v_tail.contiguous(), prefix_len, tail_len, softcap=softcap,
              scale=scale, window=window, k_scales=k_scales, v_scales=v_scales)
