"""Shared decode arithmetic: page relevance, the online-softmax step over one
KV unit, and the split-state combine.

Each piece exists twice, once per route, and the two are kept in step:

  * here, in PyTorch, for the plain decode path
    (``paged_decode_attention.paged_flash_decode_plain``);
  * in ``csrc/decode_common.cuh`` as CUDA device functions included by both
    decode kernels (one-pass K3 and split-K K4) and the combine kernel.

Port of ``repro.kernels.decode_common`` (``chunk_relevant`` at ``:36``,
``accumulate_kv_block`` at ``:54``, ``combine_split_states`` at ``:107``).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def dead_block(live: torch.Tensor) -> bool:
    """Whether a plain walk may skip a block that no row needs. Never while
    a CUDA graph captures: a graph cannot branch on data, so every block is
    computed and then masked, to the same result."""
    if live.is_cuda and torch.cuda.is_current_stream_capturing():
        return False
    return not bool(live.any())


def chunk_relevant(chunk_start, chunk_len: int, length, window):
    """True iff the KV unit ``[chunk_start, chunk_start + chunk_len)`` can
    hold a valid key for a decode row of ``length`` live tokens: a position
    ``pos`` is valid when ``pos < length`` and, under a sliding window of
    size W, ``pos > length - 1 - W``. Works on ints and on tensors."""
    relevant = chunk_start < length
    if window is not None and window > 0:
        relevant = relevant & (chunk_start + chunk_len - 1 >= length - window)
    return relevant


def accumulate_kv_block(q, k, v, acc, m, l, *, scale, softcap, window,
                        block_start: int, length, k_scale=None, v_scale=None):
    """One online-softmax step over a KV unit for a batch of decode rows.

    q: ``(N, G, D)`` fp32; k/v: ``(N, block_len, D)``; acc ``(N, G, D)``,
    m/l ``(N, G, 1)`` running state; ``length`` ``(N,)``. Positions at or
    past ``length`` (and outside the window) are masked per element, by
    select: their V rows are zeroed before the product, so a NaN there never
    reaches the row. The caller gates whole irrelevant units with
    :func:`chunk_relevant`. ``k_scale`` / ``v_scale`` ``(N,)``: a quantized
    unit's codes widen to float32 and are multiplied by their page's scale
    before the products, as the JAX kernel does. Returns the new ``(acc, m,
    l)``.
    """
    block_len = k.shape[1]
    k, v = k.float(), v.float()
    if k_scale is not None:
        k = k * k_scale[:, None, None]
        v = v * v_scale[:, None, None]
    s = torch.einsum("ngd,ntd->ngt", q, k) * scale
    if softcap is not None and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = block_start + torch.arange(block_len, device=q.device)[None, None, :]
    ln = length[:, None, None]
    valid = pos < ln
    if window is not None and window > 0:
        valid = valid & (pos > ln - 1 - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
    alpha = torch.exp(m - m_new)
    p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    v = torch.where(valid[:, 0, :, None], v, torch.zeros_like(v))
    acc = acc * alpha + torch.einsum("ngt,ntd->ngd", p, v)
    return acc, m_new, l


def combine_split_states(acc, m, l):
    """Merge per-split online-softmax states into the final attention row.

    acc: ``(..., S, G, D)`` unnormalized accumulators, one per split; m, l:
    ``(..., S, G, 1)``. Returns ``(..., G, D)`` float32: ``sum_s exp(m_s -
    m*) acc_s`` over ``sum_s exp(m_s - m*) l_s``. Empty splits carry
    ``(0, NEG_INF, 0)`` and vanish; a row with no live split emits zeros.
    """
    m_star = m.max(dim=-3, keepdim=True).values
    alpha = torch.exp(m - m_star)
    l_star = (l * alpha).sum(dim=-3)
    acc_star = (acc * alpha).sum(dim=-3)
    return acc_star / torch.where(l_star == 0, 1.0, l_star)
