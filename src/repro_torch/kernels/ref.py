"""Exact attention oracles in PyTorch (the port of ``repro.kernels.ref``).

Straightforward float32 implementations of every attention function on the
serving path, with the JAX package's layouts at their signatures: q
``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)``, head-major page pools
``(Hkv, P, page_size, D)``. They run on any device; the tests hold them
against ``repro.kernels.ref`` on the CPU and the CUDA kernels against the
plain versions beside them on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.cache import quant
from repro_torch.cache.layout import decode_split_ranges

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free
#: The plain versions of K1 and K5 / K6 hold (B, Hq, Sq, Skv) float32 scores
#: and several tensors of that size at once. Past this many elements (1 GiB
#: a tensor) they run one batch row and as many kv heads as fit at a time
#: (:func:`score_blocks`): mixtral-8x7b's 6144-token prefill at Hq 32 would
#: otherwise hold ~20 GB beside 70 GB of weights.
PLAIN_SCORE_ELEMS = 1 << 28


def score_blocks(b: int, hkv: int, group: int, sq: int, skv: int):
    """None where the whole (B, Hq, Sq, Skv) score tensor is at most
    :data:`PLAIN_SCORE_ELEMS`; else the (batch row, first kv head, end kv
    head) blocks that cover it, each with the whole GQA group of its kv
    heads (so dK / dV sum over the group inside one block)."""
    per_head = max(1, group * sq * skv)
    if b * hkv * per_head <= PLAIN_SCORE_ELEMS:
        return None
    hc = max(1, min(hkv, PLAIN_SCORE_ELEMS // per_head))
    return [(bi, h0, min(h0 + hc, hkv)) for bi in range(b) for h0 in range(0, hkv, hc)]


def _expand_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, Hkv*group, S, D) by repetition (GQA)."""
    if group == 1:
        return x
    return torch.repeat_interleave(x, group, dim=1)


def _softcap(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    if softcap is not None and softcap > 0:
        return softcap * torch.tanh(s / softcap)
    return s


def attention_mask(q_len: int, kv_len: int, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask. True = attend."""
    rows = torch.arange(q_len, device=device)[:, None] + q_offset
    cols = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None and window > 0:
        mask &= cols > rows - window
    return mask


def _scores(q, k, scale, softcap, causal, window, q_offset):
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    k = _expand_kv(k, hq // hkv)
    if scale is None:
        scale = 1.0 / d**0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = _softcap(s, softcap)
    if causal or window is not None:
        mask = attention_mask(sq, skv, causal=causal, window=window,
                              q_offset=q_offset, device=q.device)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    return s


def attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
              q_offset=0) -> torch.Tensor:
    """Exact multi-head attention. Returns (B, Hq, Sq, D) in q.dtype."""
    s = _scores(q, k, scale, softcap, causal, window, q_offset)
    p = torch.softmax(s, dim=-1)
    v = _expand_kv(v, q.shape[1] // v.shape[1])
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_lse(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None, q_offset=0) -> torch.Tensor:
    """Row logsumexp of the (scaled, capped, masked) logits. (B, Hq, Sq)."""
    s = _scores(q, k, scale, softcap, causal, window, q_offset)
    return torch.logsumexp(s, dim=-1)


def _decode_scores(q, k, v, lengths, softcap, scale, window):
    b, hq, d = q.shape
    smax = k.shape[2]
    group = hq // k.shape[1]
    k = _expand_kv(k, group)
    v = _expand_kv(v, group)
    if scale is None:
        scale = 1.0 / d**0.5
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(smax, device=q.device)[None, None, :]
    ln = lengths.to(q.device).long()[:, None, None]
    valid = pos < ln
    if window is not None and window > 0:
        valid &= pos > (ln - 1 - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    return s, valid, v


def decode_attention(q, k_cache, v_cache, lengths, *, softcap=None, scale=None,
                     window=None) -> torch.Tensor:
    """Single-token decode over a dense cache. q (B, Hq, D); caches
    (B, Hkv, Smax, D); lengths (B,). Length-0 rows give exact zeros."""
    s, valid, v = _decode_scores(q, k_cache, v_cache, lengths, softcap,
                                 scale, window)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhk,bhkd->bhd", p / torch.where(l == 0, 1.0, l), v.float())
    return o.to(q.dtype)


def split_decode_attention(q, k_cache, v_cache, lengths, *, num_splits: int,
                           granule: int, softcap=None, scale=None,
                           window=None) -> torch.Tensor:
    """Split-K decode oracle: exact per-range ``(m, l, acc)`` states over
    :func:`decode_split_ranges` of ``granule``-sized units, combined by
    rescaling to the global row max."""
    s, valid, v = _decode_scores(q, k_cache, v_cache, lengths, softcap,
                                 scale, window)
    b, hq, d = q.shape
    smax = k_cache.shape[2]
    states = []
    for start, end in decode_split_ranges(-(-smax // granule), num_splits):
        lo, hi = start * granule, min(end * granule, smax)
        sr, vr = s[:, :, lo:hi], valid[:, :, lo:hi]
        if sr.shape[-1] == 0:
            m_r = torch.full((b, hq, 1), NEG_INF, device=q.device)
            l_r = torch.zeros_like(m_r)
            acc_r = torch.zeros((b, hq, d), device=q.device)
        else:
            any_live = vr.any(dim=-1, keepdim=True)
            m_r = torch.where(any_live, sr.max(dim=-1, keepdim=True).values,
                              torch.full_like(sr[..., :1], NEG_INF))
            p_r = torch.where(vr, torch.exp(sr - m_r), torch.zeros_like(sr))
            l_r = p_r.sum(dim=-1, keepdim=True)
            acc_r = torch.einsum("bhk,bhkd->bhd", p_r, v[:, :, lo:hi].float())
        states.append((m_r, l_r, acc_r))
    m_all = torch.stack([m_ for m_, _, _ in states])
    alpha = torch.exp(m_all - m_all.max(dim=0).values[None])
    l_star = sum(a_ * l_ for a_, (_, l_, _) in zip(alpha, states))
    acc_star = sum(a_ * acc_ for a_, (_, _, acc_) in zip(alpha, states))
    o = acc_star / torch.where(l_star == 0, 1.0, l_star)
    return o.to(q.dtype)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense view of head-major pages: (Hkv, P, ps, D) + (B, mp) ->
    (B, Hkv, mp * ps, D), logical order per sequence. ``scales`` ((Hkv, P)
    float32) marks the pool as quantized codes: each gathered page is
    dequantized by its (head, page) scale, in float32."""
    hkv, _, ps, d = pages.shape
    b, mp = page_table.shape
    flat = page_table.reshape(-1).long()
    g = quant.index_pages(pages, (slice(None), flat))  # (Hkv, B*mp, ps, D)
    if scales is not None:
        g = g.float() * scales[:, flat][..., None, None]
    return g.reshape(hkv, b, mp * ps, d).transpose(0, 1)


def paged_prefill_attention(q, k_pages, v_pages, page_table, k_tail, v_tail,
                            prefix_len, tail_len, *, softcap=None, scale=None,
                            window=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """Prefix-extension prefill oracle: gather the prefix pages, append the
    tail K/V, exact attention with per-row offsets. Rows at or past
    ``tail_len`` give exact zeros. ``k_scales`` / ``v_scales`` dequantize
    quantized pools (:func:`gather_pages`). Returns (B, Hq, St, D)."""
    quant.scale_pair(k_scales, v_scales)
    b, hq, st, d = q.shape
    group = hq // k_pages.shape[0]
    kp = gather_pages(k_pages, page_table, k_scales).to(k_tail.dtype)
    vp = gather_pages(v_pages, page_table, v_scales).to(v_tail.dtype)
    sp = kp.shape[2]
    k = _expand_kv(torch.cat([kp, k_tail], dim=2), group)
    v = _expand_kv(torch.cat([vp, v_tail], dim=2), group)
    if scale is None:
        scale = 1.0 / d**0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = _softcap(s, softcap)
    dev = q.device
    plen = prefix_len.to(dev).long()
    tlen = tail_len.to(dev).long()
    rows = torch.arange(st, device=dev)[None, :]
    rows_abs = plen[:, None] + rows
    col_pref = torch.arange(sp, device=dev)[None, :]
    col_tail = torch.arange(st, device=dev)[None, :]
    m_pref = (col_pref < plen[:, None])[:, None, :].expand(b, st, sp)
    m_tail = (col_tail[:, None, :] <= rows[:, :, None]) & \
        (col_tail < tlen[:, None])[:, None, :]
    mask = torch.cat([m_pref, m_tail.expand(b, st, st)], dim=-1)
    if window is not None and window > 0:
        col_abs = torch.cat([col_pref.expand(b, sp), plen[:, None] + col_tail],
                            dim=-1)
        mask = mask & (col_abs[:, None, :] > rows_abs[:, :, None] - window)
    mask = mask & (rows < tlen[:, None])[:, :, None]
    mask = mask[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / torch.where(l == 0, 1.0, l),
                     v.float())
    return o.to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           softcap=None, scale=None, window=None, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """Paged decode oracle: gather pages to a dense cache (dequantized by
    ``k_scales`` / ``v_scales`` for a quantized pool), then the dense
    oracle (the gather is exactly what the paged kernels avoid)."""
    quant.scale_pair(k_scales, v_scales)
    k = gather_pages(k_pages, page_table, k_scales)
    v = gather_pages(v_pages, page_table, v_scales)
    return decode_attention(q, k, v, lengths, softcap=softcap, scale=scale,
                            window=window)
