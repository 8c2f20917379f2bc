"""K2: paged prefix-extension prefill — the CUDA kernel and its plain version.

Port of ``repro.kernels.paged_prefill_attention.paged_flash_prefill``. Tail
queries at absolute positions ``prefix_len[b] + i`` attend to the prefix
K/V read through the page table and causally to the dense tail K/V, under
one online softmax. The kernel is ``csrc/paged_prefill.cu``: folded
(position, head) rows are tiled 64 at a time, position-major, so each
prefix page is read once per (b, kv head, row tile) for every q head of the
GQA group. :func:`paged_flash_prefill` launches it for CUDA tensors and runs
:func:`paged_flash_prefill_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF, _softcap

HEAD_DIMS = (64, 128)

#: Launches of the CUDA kernel since the last reset.
launches = 0


def paged_flash_prefill_plain(q, k_pages, v_pages, page_table, k_tail, v_tail,
                              prefix_len, tail_len, *, softcap=None,
                              scale=None, window=None) -> torch.Tensor:
    """What K2 computes, in plain PyTorch: the prefix pages read through the
    table (only the live ``prefix_len`` columns), then the causal tail, one
    softmax per row; rows at or past ``tail_len`` give exact zeros."""
    b, hq, st, d = q.shape
    hkv, _, ps, _ = k_pages.shape
    group = hq // hkv
    mp = page_table.shape[1]
    if scale is None:
        scale = 1.0 / d**0.5
    dev = q.device
    plen = prefix_len.to(dev).long()
    tlen = tail_len.to(dev).long()
    table = page_table.to(dev).long()
    # (B, Hkv, mp * ps, D): the prefix view the kernel walks page by page.
    kp = k_pages[:, table].permute(1, 0, 2, 3, 4).reshape(b, hkv, mp * ps, d)
    vp = v_pages[:, table].permute(1, 0, 2, 3, 4).reshape(b, hkv, mp * ps, d)
    k = torch.cat([kp, k_tail], dim=2).float()
    v = torch.cat([vp, v_tail], dim=2).float()
    qg = q.float().reshape(b, hkv, group, st, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale
    s = _softcap(s, softcap)
    rows = torch.arange(st, device=dev)
    col_p = torch.arange(mp * ps, device=dev)
    col_t = torch.arange(st, device=dev)
    row_ok = rows[None, :] < tlen[:, None]                                  # (B, St)
    m_pref = (col_p[None, None, :] < plen[:, None, None]) & row_ok[:, :, None]
    m_tail = (col_t[None, None, :] <= rows[None, :, None]) & row_ok[:, :, None]
    if window is not None and window > 0:
        m_pref = m_pref & (col_p[None, None, :] >
                           plen[:, None, None] + rows[None, :, None] - window)
        m_tail = m_tail & (col_t[None, None, :] > rows[None, :, None] - window)
    mask = torch.cat([m_pref, m_tail], dim=-1)[:, None, None]              # (B,1,1,St,K)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / torch.where(l == 0, 1.0, l), v)
    return o.reshape(b, hq, st, d).to(q.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _fn = build.bind("paged_prefill", "paged_prefill",
                         [P] * 9 + [I] * 8 + [F, I, F, I, P])
    return _fn


def _check_inputs(q, k_pages, v_pages, page_table, k_tail, v_tail,
                  prefix_len, tail_len):
    dev = q.device
    tensors = (("k_pages", k_pages), ("v_pages", v_pages),
               ("page_table", page_table), ("k_tail", k_tail),
               ("v_tail", v_tail), ("prefix_len", prefix_len),
               ("tail_len", tail_len))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or any(
            t.dtype != q.dtype for t in (k_pages, v_pages, k_tail, v_tail)):
        raise ValueError(f"q, pools and tail must share a dtype in {list(_DTYPES)}")
    for name, t in (("page_table", page_table), ("prefix_len", prefix_len),
                    ("tail_len", tail_len)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    b, hq, st, d = q.shape
    hkv = k_pages.shape[0]
    if k_tail.shape != (b, hkv, st, d) or v_tail.shape != k_tail.shape:
        raise ValueError(f"tail K/V shape {tuple(k_tail.shape)} != {(b, hkv, st, d)}")
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d:
        raise ValueError("pool shapes do not match q")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not divisible by Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if page_table.shape[0] != b or prefix_len.shape != (b,) or tail_len.shape != (b,):
        raise ValueError("page_table / prefix_len / tail_len batch does not match q")
    for name, t in (("q", q),) + tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_flash_prefill(q, k_pages, v_pages, page_table, k_tail, v_tail,
                        prefix_len, tail_len, *, softcap=None, scale=None,
                        window=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """q (B, Hq, St, D) tail queries; k/v_pages (Hkv, P, page_size, D);
    page_table (B, mp) int32 physical ids (null-page padded past the live
    prefix; mp may be 0); k/v_tail (B, Hkv, St, D); prefix_len / tail_len
    (B,) int32. Returns (B, Hq, St, D). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "quantized page pools are not ported yet (ROADMAP Queue A, "
            "quantized and tiered KV)")
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(
            q, k_pages, v_pages, page_table, k_tail, v_tail, prefix_len,
            tail_len, softcap=softcap, scale=scale, window=window)
    _check_inputs(q, k_pages, v_pages, page_table, k_tail, v_tail,
                  prefix_len, tail_len)
    build.refuse_grad("paged_flash_prefill", q, k_pages, v_pages, k_tail, v_tail)
    b, hq, st, d = q.shape
    hkv, num_pages, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    if scale is None:
        scale = 1.0 / d**0.5
    o = torch.empty_like(q)
    global launches
    launches += 1
    status = _kernel()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
        prefix_len.data_ptr(), tail_len.data_ptr(), o.data_ptr(),
        b, hq, hkv, st, num_pages, ps, mp, d,
        float(scale), int(window or 0), float(softcap or 0.0),
        _DTYPES[q.dtype], build.stream_of(q),
    )
    build.check(status, "paged_prefill")
    return o
