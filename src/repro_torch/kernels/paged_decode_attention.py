"""K3 and K4: paged flash-decode, one-pass and split-K — the CUDA kernels
and their plain version.

Port of ``repro.kernels.paged_decode_attention.paged_flash_decode`` and
``_paged_flash_decode_split``. The kernels are ``csrc/paged_decode.cu``,
one block per (b, kv head), or per (b, kv head, split), serving the whole
GQA group from each page it loads; the split states merge in a second
small kernel. bf16 runs ``paged_decode_tc`` / ``paged_decode_split_tc`` on
the tensor cores: a producer warp loads K/V page by page by TMA into the
64-row stages of a 128 KB ring, and the consumer warps are the ones K7/K8
run (``csrc/decode_tc.cuh``); the page size must then be a multiple of 8
that divides 64. float32 runs ``paged_decode`` / ``paged_decode_split`` on
the CUDA cores (the tensor cores would round it to TF32).
:func:`paged_flash_decode` launches the one for its dtype on CUDA tensors
and runs :func:`paged_flash_decode_plain` — the same page walk, relevance
gate and split combine, written with ``decode_common`` — for CPU tensors.
The quantized-pool scale branch of the TPU kernels is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.cache.layout import decode_split_ranges
from repro_torch.kernels import build, decode_common

HEAD_DIMS = (64, 128)
MAX_GROUP = 32
#: Positions staged per step (DC_BT in csrc/decode_common.cuh, dtc::BT in
#: csrc/decode_tc.cuh).
STAGE = 64
#: bf16 page sizes must be multiples of this: the 128-byte swizzle of a
#: tensor-core stage repeats every 8 rows, so a page's box then lands where
#: one 64-row box would put it.
TC_PAGE_MULTIPLE = 8

#: Launches since the last reset: one-pass (K3) and split-K (K4; each
#: launch is the split kernel followed by its combine), of either dtype;
#: the ``_tc`` keys count the bf16 tensor-core kernel's alone.
launches = {"one_pass": 0, "split": 0, "one_pass_tc": 0, "split_tc": 0}


def paged_flash_decode_plain(q, k_pages, v_pages, page_table, lengths, *,
                             softcap=None, scale=None, window=None,
                             num_splits: int = 1) -> torch.Tensor:
    """What K3/K4 compute, in plain PyTorch: per split range of pages, an
    online-softmax walk over the relevant pages, then the combine."""
    b, hq, d = q.shape
    hkv, _, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / d**0.5
    qg = q.float().reshape(b * hkv, group, d)
    lengths = lengths.to(q.device).long()
    ln = lengths.repeat_interleave(hkv)                      # (B*Hkv,)
    table = page_table.to(q.device).long()
    heads = torch.arange(hkv, device=q.device).repeat(b)     # (B*Hkv,)
    states = []
    for start, end in decode_split_ranges(mp, num_splits):
        acc = torch.zeros((b * hkv, group, d), device=q.device)
        m = torch.full((b * hkv, group, 1), decode_common.NEG_INF, device=q.device)
        l = torch.zeros((b * hkv, group, 1), device=q.device)
        for p in range(start, end):
            live = decode_common.chunk_relevant(p * ps, ps, ln, window)
            if decode_common.dead_block(live):
                continue
            pids = table[:, p].repeat_interleave(hkv)
            k = k_pages[heads, pids]                           # (B*Hkv, ps, D)
            v = v_pages[heads, pids]
            acc1, m1, l1 = decode_common.accumulate_kv_block(
                qg, k, v, acc, m, l, scale=scale, softcap=softcap,
                window=window, block_start=p * ps, length=ln)
            keep = live[:, None, None]
            acc = torch.where(keep, acc1, acc)
            m = torch.where(keep, m1, m)
            l = torch.where(keep, l1, l)
        states.append((acc, m, l))
    acc = torch.stack([s[0] for s in states], dim=1)
    m = torch.stack([s[1] for s in states], dim=1)
    l = torch.stack([s[2] for s in states], dim=1)
    out = decode_common.combine_split_states(acc, m, l)
    return out.reshape(b, hq, d).to(q.dtype)


_DTYPES = (torch.float32, torch.bfloat16)
#: (dtype, split) -> the C entry point that takes it.
_ENTRY = {(torch.float32, False): "paged_decode", (torch.float32, True): "paged_decode_split",
          (torch.bfloat16, False): "paged_decode_tc",
          (torch.bfloat16, True): "paged_decode_split_tc"}
_fns = {}


def _kernel(dtype, split: bool):
    fn = _fns.get((dtype, split))
    if fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if split:
            args = [P] * 9 + [I] * 9 + [F, I, F, P]
        else:
            args = [P] * 6 + [I] * 7 + [F, I, F, P]
        fn = _fns[(dtype, split)] = build.bind("paged_decode", _ENTRY[(dtype, split)], args)
    return fn


def _check_inputs(q, k_pages, v_pages, page_table, lengths):
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"q and the pools must share a dtype in {list(_DTYPES)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    b, hq, d = q.shape
    hkv, _, ps, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError("pool shapes do not match q")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"GQA group Hq/Hkv={hq}/{hkv} unsupported")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if ps > STAGE or STAGE % ps:
        raise ValueError(f"page_size {ps} must divide {STAGE}")
    if q.dtype == torch.bfloat16 and ps % TC_PAGE_MULTIPLE:
        raise ValueError(f"bf16 page_size {ps} must be a multiple of {TC_PAGE_MULTIPLE} "
                         "(the tensor-core kernel's swizzled stages)")
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("page_table / lengths batch does not match q")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pools must start 16-byte aligned (16-byte loads, tensor maps)")


def paged_flash_decode(q, k_pages, v_pages, page_table, lengths, *,
                       softcap=None, scale=None, window=None,
                       num_splits: int = 1, k_scales=None, v_scales=None
                       ) -> torch.Tensor:
    """q (B, Hq, D); k/v_pages (Hkv, P, page_size, D) head-major;
    page_table (B, max_pages) int32 (entries past a row's live pages hold a
    valid id — the null page); lengths (B,) int32. Returns (B, Hq, D).

    ``num_splits > 1`` runs split-K over :func:`decode_split_ranges`
    (clamped to the table width). CUDA tensors launch the kernel of their
    dtype (bf16 on the tensor cores, float32 on the CUDA cores), CPU tensors
    take the plain version; under grad mode it raises: the kernels have no
    backward.
    """
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "quantized page pools are not ported yet (ROADMAP Queue A, "
            "quantized and tiered KV)")
    if q.device.type == "cpu":
        return paged_flash_decode_plain(
            q, k_pages, v_pages, page_table, lengths, softcap=softcap,
            scale=scale, window=window, num_splits=num_splits)
    _check_inputs(q, k_pages, v_pages, page_table, lengths)
    build.refuse_grad("paged_flash_decode", q, k_pages, v_pages)
    b, hq, d = q.shape
    hkv, num_pages, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    if scale is None:
        scale = 1.0 / d**0.5
    ranges = decode_split_ranges(mp, num_splits)
    out = torch.empty_like(q)
    common = (float(scale), int(window or 0), float(softcap or 0.0), build.stream_of(q))
    tc = q.dtype == torch.bfloat16
    if len(ranges) == 1:
        launches["one_pass"] += 1
        launches["one_pass_tc"] += int(tc)
        status = _kernel(q.dtype, False)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, hq, hkv, num_pages, ps, mp, d, *common)
        build.check(status, _ENTRY[(q.dtype, False)])
        return out
    s = len(ranges)
    pps = ranges[0][1] - ranges[0][0]
    group = hq // hkv
    acc = torch.empty((b, hkv, s, group, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, s, group), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    launches["split"] += 1
    launches["split_tc"] += int(tc)
    status = _kernel(q.dtype, True)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, hq, hkv, num_pages, ps, mp, d, s, pps, *common)
    build.check(status, _ENTRY[(q.dtype, True)])
    return out
