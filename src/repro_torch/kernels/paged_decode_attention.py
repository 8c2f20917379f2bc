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
the CUDA cores (the tensor cores would round it to TF32). A quantized pool
(int8 or float8_e4m3fn codes with ``(Hkv, P)`` float32 ``k_scales`` /
``v_scales``, ``cache.quant``) computes the TPU kernels' scale branch. With
bf16 q it runs ``paged_decode_q_tc`` / ``paged_decode_split_q_tc`` on the
tensor cores: the same walk and consumer, fed the 1-byte codes page by page
by TMA, each consumer warp widening a stage of codes exactly into a bf16
tile of its own (at head_dim 256 a widening warpgroup beside the consumer
warps widens each code stage into a bf16 stage, which they read as over a
bf16 pool), with K's page scales folded into S's columns and V's into P's;
the page size must then be a multiple of 8 that divides 64, as for a bf16
pool. With float32 q it runs ``paged_decode_q`` /
``paged_decode_split_q``: the float32 CUDA-core walk, each code widened to
float32 and multiplied by its page's scale where it is staged
(:func:`paged_flash_decode_q_cuda_cores` runs that walk for bf16 q too,
the design the tensor-core kernel replaced, so one run can time both).
:func:`paged_flash_decode` launches the one for its dtypes on CUDA tensors
and runs :func:`paged_flash_decode_plain` — the same page walk, relevance
gate and split combine, written with ``decode_common`` — for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.cache import quant
from repro_torch.cache.layout import decode_split_ranges
from repro_torch.kernels import build, decode_common

#: Head dims of the float32 kernels (over a float32 or a quantized pool).
HEAD_DIMS = (64, 128)
#: Head dims of the bf16 tensor-core kernels, over a bf16 or a quantized
#: pool: 256 too.
TC_HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 32
#: Positions staged per step (DC_BT in csrc/decode_common.cuh, dtc::BT in
#: csrc/decode_tc.cuh).
STAGE = 64
#: Page sizes of bf16 q (over a bf16 or a quantized pool) must be multiples
#: of this: the swizzle of a tensor-core stage repeats every 8 rows, so a
#: page's box then lands where one 64-row box would put it.
TC_PAGE_MULTIPLE = 8

#: Launches since the last reset: one-pass (K3) and split-K (K4; each
#: launch is the split kernel followed by its combine) over an unquantized
#: pool, of either dtype; the ``_tc`` keys count the bf16 tensor-core
#: kernel's alone; the ``_q`` keys count the kernels over a quantized pool,
#: of either q dtype, and the ``_q_tc`` keys those of them on the tensor
#: cores (bf16 q) alone.
launches = {"one_pass": 0, "split": 0, "one_pass_tc": 0, "split_tc": 0,
            "one_pass_q": 0, "split_q": 0, "one_pass_q_tc": 0, "split_q_tc": 0}


def paged_flash_decode_plain(q, k_pages, v_pages, page_table, lengths, *,
                             softcap=None, scale=None, window=None,
                             num_splits: int = 1, k_scales=None, v_scales=None
                             ) -> torch.Tensor:
    """What K3/K4 compute, in plain PyTorch: per split range of pages, an
    online-softmax walk over the relevant pages, then the combine. A
    quantized pool's pages are dequantized by their scales in the block
    step."""
    k_scale_tab, v_scale_tab = k_scales, v_scales
    quantized = quant.scale_pair(k_scale_tab, v_scale_tab)
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
            k = quant.index_pages(k_pages, (heads, pids))      # (B*Hkv, ps, D)
            v = quant.index_pages(v_pages, (heads, pids))
            k_sc = k_scale_tab[heads, pids] if quantized else None
            v_sc = v_scale_tab[heads, pids] if quantized else None
            acc1, m1, l1 = decode_common.accumulate_kv_block(
                qg, k, v, acc, m, l, scale=scale, softcap=softcap,
                window=window, block_start=p * ps, length=ln, k_scale=k_sc,
                v_scale=v_sc)
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
#: Code dtypes of a quantized pool.
_CODES = (torch.int8, torch.float8_e4m3fn)
#: (route, split) -> the C entry point that takes it: route a dtype for an
#: unquantized pool; "q" a quantized pool on the CUDA cores (q float32 or
#: bf16, selected by an argument), "q_tc" one on the tensor cores (bf16 q).
_ENTRY = {(torch.float32, False): "paged_decode", (torch.float32, True): "paged_decode_split",
          (torch.bfloat16, False): "paged_decode_tc",
          (torch.bfloat16, True): "paged_decode_split_tc",
          ("q", False): "paged_decode_q", ("q", True): "paged_decode_split_q",
          ("q_tc", False): "paged_decode_q_tc", ("q_tc", True): "paged_decode_split_q_tc"}
#: Integer arguments after the pointers (B .. D, then num_splits and
#: pages_per_split for a split, then the quantized entries' dtype flags).
_INTS = {"q": 2, "q_tc": 1}
_fns = {}


def _kernel(route, split: bool):
    fn = _fns.get((route, split))
    if fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pointers = 6 + 2 * (route in _INTS) + 3 * split
        ints = 7 + 2 * split + _INTS.get(route, 0)
        args = [P] * pointers + [I] * ints + [F, I, F, P]
        fn = _fns[(route, split)] = build.bind("paged_decode", _ENTRY[(route, split)], args)
    return fn


def _check_inputs(q, k_pages, v_pages, page_table, lengths, k_scale_tab=None,
                  v_scale_tab=None, tensor_cores=False, head_dims=HEAD_DIMS):
    dev = q.device
    tensors = (("k_pages", k_pages), ("v_pages", v_pages), ("page_table", page_table),
               ("lengths", lengths))
    quantized = k_scale_tab is not None
    if quantized:
        tensors += (("k_scales", k_scale_tab), ("v_scales", v_scale_tab))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be one of {list(_DTYPES)}")
    if quantized:
        if k_pages.dtype not in _CODES or v_pages.dtype != k_pages.dtype:
            raise ValueError(f"quantized pools must share a code dtype in {list(_CODES)}")
        hkv, num_pages = k_pages.shape[:2]
        for name, t in (("k_scales", k_scale_tab), ("v_scales", v_scale_tab)):
            if t.dtype != torch.float32 or t.shape != (hkv, num_pages):
                raise ValueError(f"{name} must be float32 of shape {(hkv, num_pages)}")
    elif k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"q and the pools must share a dtype in {list(_DTYPES)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    b, hq, d = q.shape
    hkv, _, ps, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError("pool shapes do not match q")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"GQA group Hq/Hkv={hq}/{hkv} unsupported")
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not in {head_dims} for this pool and q dtype on "
                         "the card")
    if ps > STAGE or STAGE % ps:
        raise ValueError(f"page_size {ps} must divide {STAGE}")
    if tensor_cores and ps % TC_PAGE_MULTIPLE:
        raise ValueError(f"bf16 page_size {ps} must be a multiple of {TC_PAGE_MULTIPLE} "
                         "(the tensor-core kernel's swizzled stages)")
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("page_table / lengths batch does not match q")
    for name, t in (("q", q),) + tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the pools must start 16-byte aligned (16-byte loads, "
                         "tensor maps)")


def paged_flash_decode(q, k_pages, v_pages, page_table, lengths, *,
                       softcap=None, scale=None, window=None,
                       num_splits: int = 1, k_scales=None, v_scales=None
                       ) -> torch.Tensor:
    """q (B, Hq, D); k/v_pages (Hkv, P, page_size, D) head-major;
    page_table (B, max_pages) int32 (entries past a row's live pages hold a
    valid id — the null page); lengths (B,) int32. Returns (B, Hq, D).
    ``k_scales`` / ``v_scales`` (Hkv, P) float32, both or neither, mark the
    pools as int8 or float8_e4m3fn codes (``cache.quant``).

    ``num_splits > 1`` runs split-K over :func:`decode_split_ranges`
    (clamped to the table width). CUDA tensors launch the kernel of their
    dtypes (bf16 q on the tensor cores, over a bf16 or a quantized pool;
    float32 q on the CUDA cores), CPU tensors take the plain version; under
    grad mode it raises: the kernels have no backward.
    """
    k_scale_tab, v_scale_tab = k_scales, v_scales
    quantized = quant.scale_pair(k_scale_tab, v_scale_tab)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(
            q, k_pages, v_pages, page_table, lengths, softcap=softcap,
            scale=scale, window=window, num_splits=num_splits, k_scales=k_scale_tab,
            v_scales=v_scale_tab)
    route = q.dtype
    if quantized:
        route = "q_tc" if q.dtype == torch.bfloat16 else "q"
    return _launch(route, q, k_pages, v_pages, page_table, lengths, softcap=softcap,
                   scale=scale, window=window, num_splits=num_splits,
                   k_scale_tab=k_scale_tab, v_scale_tab=v_scale_tab)


def paged_flash_decode_q_cuda_cores(q, k_pages, v_pages, page_table, lengths, *,
                                    softcap=None, scale=None, window=None,
                                    num_splits: int = 1, k_scales=None, v_scales=None
                                    ) -> torch.Tensor:
    """:func:`paged_flash_decode` over a quantized pool (CUDA tensors only)
    on the float32 CUDA-core walk for either q dtype: what bf16 q ran before
    its tensor-core kernel, kept so that one run can time the two. Counted
    under the ``_q`` keys alone."""
    k_scale_tab, v_scale_tab = k_scales, v_scales
    if not quant.scale_pair(k_scale_tab, v_scale_tab) or q.device.type != "cuda":
        raise ValueError("paged_flash_decode_q_cuda_cores takes a quantized pool on the card")
    return _launch("q", q, k_pages, v_pages, page_table, lengths, softcap=softcap,
                   scale=scale, window=window, num_splits=num_splits,
                   k_scale_tab=k_scale_tab, v_scale_tab=v_scale_tab)


def _launch(route, q, k_pages, v_pages, page_table, lengths, *, softcap, scale, window,
            num_splits, k_scale_tab, v_scale_tab):
    """Check the inputs and launch the entry of ``route`` (see ``_ENTRY``),
    counting it."""
    quantized = route in _INTS
    tc = route in (torch.bfloat16, "q_tc")
    _check_inputs(q, k_pages, v_pages, page_table, lengths, k_scale_tab, v_scale_tab, tc,
                  TC_HEAD_DIMS if tc else HEAD_DIMS)
    build.refuse_grad("paged_flash_decode", q, k_pages, v_pages)
    b, hq, d = q.shape
    hkv, num_pages, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    if scale is None:
        scale = 1.0 / d**0.5
    ranges = decode_split_ranges(mp, num_splits)
    out = torch.empty_like(q)
    common = (float(scale), int(window or 0), float(softcap or 0.0), build.stream_of(q))
    pointers = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    if quantized:
        pointers += (k_scale_tab.data_ptr(), v_scale_tab.data_ptr())
    pointers += (page_table.data_ptr(), lengths.data_ptr(), out.data_ptr())
    fp8 = int(k_pages.dtype == torch.float8_e4m3fn)
    flags = {"q": (int(q.dtype == torch.bfloat16), fp8), "q_tc": (fp8,)}.get(route, ())
    suffix = "_q" if quantized else ""
    if len(ranges) == 1:
        launches["one_pass" + suffix] += 1
        launches["one_pass" + suffix + "_tc"] += int(tc)
        status = _kernel(route, False)(*pointers, b, hq, hkv, num_pages, ps, mp, d, *flags,
                                       *common)
        build.check(status, _ENTRY[(route, False)])
        return out
    s = len(ranges)
    pps = ranges[0][1] - ranges[0][0]
    group = hq // hkv
    acc = torch.empty((b, hkv, s, group, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, s, group), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    launches["split" + suffix] += 1
    launches["split" + suffix + "_tc"] += int(tc)
    status = _kernel(route, True)(*pointers, acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                                  b, hq, hkv, num_pages, ps, mp, d, s, pps, *flags, *common)
    build.check(status, _ENTRY[(route, True)])
    return out
