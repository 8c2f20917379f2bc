"""K2: paged prefix-extension prefill — the CUDA kernel and its plain version.

Port of ``repro.kernels.paged_prefill_attention.paged_flash_prefill``. Tail
queries at absolute positions ``prefix_len[b] + i`` attend to the prefix
K/V read through the page table and causally to the dense tail K/V, under
one online softmax. The kernels are in ``csrc/paged_prefill.cu``. bf16
runs ``paged_prefill_tc`` on the tensor cores: K1's consumer warpgroups
(``csrc/prefill_tc.cuh``) over 128 query rows of one (b, q head), blocks
head-first so a GQA group's heads stream the same prefix pages through L2,
fed by a producer warp that loads each prefix page as one TMA box (the page
size must then be a multiple of 8 that divides 128) and the tail in
128-row boxes. float32 runs ``paged_prefill`` on the CUDA cores (the tensor
cores would round it to TF32): folded (position, head) rows tiled 64 at a
time. A quantized pool (int8 or float8_e4m3fn prefix codes with ``(Hkv,
P)`` float32 ``k_scales`` / ``v_scales``, ``cache.quant``) computes the TPU
kernel's scale branch. With bf16 q it runs ``paged_prefill_q_tc`` on the
tensor cores: the same walk and consumers, each page of codes loaded as
one TMA box and widened by the producer warpgroup into a bf16 stage, each
code times its page's scale rounded once to bf16, so the output is bit for bit
``paged_prefill_tc``'s over a bf16 pool of the dequantized values; the page
size must be a multiple of 8 that divides 128 (64 at head_dim 256), as for
a bf16 pool. With
float32 q it runs ``paged_prefill_q``: the float32 CUDA-core kernel with
each prefix code widened and multiplied by its page's scale where it is
staged (:func:`paged_flash_prefill_q_cuda_cores` runs that walk for bf16 q
too, the design the tensor-core kernel replaced, so one run can time
both). :func:`paged_flash_prefill` launches the one for its dtypes on CUDA
tensors and runs :func:`paged_flash_prefill_plain` for CPU tensors.

:func:`paged_prefill_gather` is the other route the plan may take for a
paged extend (the JAX package's gather oracle, ``ref.paged_prefill_attention``,
run as ``impl="xla"``): each row's live prefix gathered out of the pool
(dequantized on the way) and packed with its tail into a dense stripe, in
plain PyTorch indexing outside any kernel, then K1 with per-row query
offsets (``flash_attention.flash_attention_fwd``) over the stripe.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.cache import quant
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import NEG_INF, _softcap

#: Head dims of the float32 kernels (over a float32 or a quantized pool).
HEAD_DIMS = (64, 128)
#: Head dims of the bf16 tensor-core kernels, over a bf16 or a quantized
#: pool: 256 too.
TC_HEAD_DIMS = (64, 128, 256)
#: Keys of a tensor-core stage (ptc::Smem<D>::BN in csrc/prefill_tc.cuh; 64
#: at head dim 256): a bf16 page size must divide it and be a multiple of
#: TC_PAGE_MULTIPLE, the rows of one 128-byte swizzle period, so a page's
#: box lands where one stage-high box would put it.
TC_STAGE = 128
TC_STAGE_D256 = 64
TC_PAGE_MULTIPLE = 8

#: Launches over an unquantized pool since the last reset, of either CUDA
#: kernel; ``launches_tc`` counts those of the bf16 tensor-core kernel
#: alone, ``launches_q`` the launches over a quantized pool, of either q
#: dtype, and ``launches_q_tc`` those of them on the tensor cores (bf16 q).
launches = 0
launches_tc = 0
launches_q = 0
launches_q_tc = 0


def paged_flash_prefill_plain(q, k_pages, v_pages, page_table, k_tail, v_tail,
                              prefix_len, tail_len, *, softcap=None,
                              scale=None, window=None, k_scales=None,
                              v_scales=None) -> torch.Tensor:
    """What K2 computes, in plain PyTorch: the prefix pages read through the
    table (only the live ``prefix_len`` columns: the rest are zeroed by
    select, as the kernel stages them), then the causal tail, one softmax
    per row; rows at or past ``tail_len`` give exact zeros. A quantized
    pool's prefix pages are dequantized by their scales in float32."""
    k_scale_tab, v_scale_tab = k_scales, v_scales
    quantized = quant.scale_pair(k_scale_tab, v_scale_tab)
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
    kp = quant.index_pages(k_pages, (slice(None), table)).float()
    vp = quant.index_pages(v_pages, (slice(None), table)).float()
    if quantized:
        kp = kp * k_scale_tab[:, table][..., None, None]
        vp = vp * v_scale_tab[:, table][..., None, None]
    kp = kp.permute(1, 0, 2, 3, 4).reshape(b, hkv, mp * ps, d)
    vp = vp.permute(1, 0, 2, 3, 4).reshape(b, hkv, mp * ps, d)
    live = (torch.arange(mp * ps, device=dev)[None, :] < plen[:, None])[:, None, :, None]
    kp = torch.where(live, kp, torch.zeros_like(kp))
    vp = torch.where(live, vp, torch.zeros_like(vp))
    k = torch.cat([kp, k_tail.float()], dim=2)
    v = torch.cat([vp, v_tail.float()], dim=2)
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


#: route -> the C entry point of K2 that takes it: a dtype for an
#: unquantized pool; "q" a quantized pool on the CUDA cores (q float32 or
#: bf16, selected by an argument), "q_tc" one on the tensor cores (bf16 q).
_ENTRY = {torch.float32: "paged_prefill", torch.bfloat16: "paged_prefill_tc",
          "q": "paged_prefill_q", "q_tc": "paged_prefill_q_tc"}
#: Integer dtype flags after D: q_bf16 and fp8 for "q", fp8 for "q_tc".
_FLAGS = {"q": 2, "q_tc": 1}
_CODES = (torch.int8, torch.float8_e4m3fn)
_fns = {}


def _kernel(route):
    fn = _fns.get(route)
    if fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pointers = 11 if route in _FLAGS else 9
        args = [P] * pointers + [I] * (8 + _FLAGS.get(route, 0))
        fn = _fns[route] = build.bind("paged_prefill", _ENTRY[route], args + [F, I, F, P])
    return fn


def _check_inputs(q, k_pages, v_pages, page_table, k_tail, v_tail,
                  prefix_len, tail_len, k_scale_tab=None, v_scale_tab=None,
                  tensor_cores=False, head_dims=HEAD_DIMS):
    dev = q.device
    quantized = k_scale_tab is not None
    tensors = (("k_pages", k_pages), ("v_pages", v_pages),
               ("page_table", page_table), ("k_tail", k_tail),
               ("v_tail", v_tail), ("prefix_len", prefix_len),
               ("tail_len", tail_len))
    if quantized:
        tensors += (("k_scales", k_scale_tab), ("v_scales", v_scale_tab))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in (k_tail, v_tail)):
        raise ValueError("q and the tail must share a dtype in [float32, bfloat16]")
    if quantized:
        if k_pages.dtype not in _CODES or v_pages.dtype != k_pages.dtype:
            raise ValueError(f"quantized pools must share a code dtype in {list(_CODES)}")
        hkv, num_pages = k_pages.shape[:2]
        for name, t in (("k_scales", k_scale_tab), ("v_scales", v_scale_tab)):
            if t.dtype != torch.float32 or t.shape != (hkv, num_pages):
                raise ValueError(f"{name} must be float32 of shape {(hkv, num_pages)}")
    elif any(t.dtype != q.dtype for t in (k_pages, v_pages)):
        raise ValueError("q, pools and tail must share a dtype in [float32, bfloat16]")
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
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not in {head_dims} for this pool and q dtype on "
                         "the card")
    if page_table.shape[0] != b or prefix_len.shape != (b,) or tail_len.shape != (b,):
        raise ValueError("page_table / prefix_len / tail_len batch does not match q")
    for name, t in (("q", q),) + tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # Both kernels read rows 16 bytes at a time, and TMA needs 16-byte
    # aligned tensors.
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, k_tail, v_tail)):
        raise ValueError("q, the pools and the tail must start 16-byte aligned")
    if tensor_cores:
        ps = k_pages.shape[2]
        stage = TC_STAGE_D256 if d == 256 else TC_STAGE
        if ps % TC_PAGE_MULTIPLE or stage % ps:
            raise ValueError(f"page_size {ps} of bf16 q must be a multiple of "
                             f"{TC_PAGE_MULTIPLE} that divides {stage} (the tensor-core "
                             f"kernels' swizzled stages at head_dim {d})")
        if st == 0 or k_pages.shape[1] == 0:   # a tensor map has no empty dimension
            raise ValueError("bf16 paged_flash_prefill takes at least one tail row and "
                             "one page")


def paged_flash_prefill(q, k_pages, v_pages, page_table, k_tail, v_tail,
                        prefix_len, tail_len, *, softcap=None, scale=None,
                        window=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """q (B, Hq, St, D) tail queries; k/v_pages (Hkv, P, page_size, D);
    page_table (B, mp) int32 physical ids (null-page padded past the live
    prefix; mp may be 0); k/v_tail (B, Hkv, St, D); prefix_len / tail_len
    (B,) int32. ``k_scales`` / ``v_scales`` (Hkv, P) float32, both or
    neither, mark the pools as int8 or float8_e4m3fn codes. Returns (B, Hq,
    St, D). CUDA tensors launch the kernel of their dtypes (bf16 q on the
    tensor cores, over a bf16 or a quantized pool; float32 q on the CUDA
    cores), CPU tensors take the plain version."""
    k_scale_tab, v_scale_tab = k_scales, v_scales
    quantized = quant.scale_pair(k_scale_tab, v_scale_tab)
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(
            q, k_pages, v_pages, page_table, k_tail, v_tail, prefix_len,
            tail_len, softcap=softcap, scale=scale, window=window,
            k_scales=k_scale_tab, v_scales=v_scale_tab)
    route = q.dtype
    if quantized:
        route = "q_tc" if q.dtype == torch.bfloat16 else "q"
    return _launch(route, q, k_pages, v_pages, page_table, k_tail, v_tail, prefix_len,
                   tail_len, softcap=softcap, scale=scale, window=window,
                   k_scale_tab=k_scale_tab, v_scale_tab=v_scale_tab)


def paged_flash_prefill_q_cuda_cores(q, k_pages, v_pages, page_table, k_tail, v_tail,
                                     prefix_len, tail_len, *, softcap=None, scale=None,
                                     window=None, k_scales=None, v_scales=None
                                     ) -> torch.Tensor:
    """:func:`paged_flash_prefill` over a quantized pool (CUDA tensors only)
    on the float32 CUDA-core walk for either q dtype: what bf16 q ran before
    its tensor-core kernel, kept so that one run can time the two. Counted
    under ``launches_q`` alone."""
    k_scale_tab, v_scale_tab = k_scales, v_scales
    if not quant.scale_pair(k_scale_tab, v_scale_tab) or q.device.type != "cuda":
        raise ValueError("paged_flash_prefill_q_cuda_cores takes a quantized pool on the card")
    return _launch("q", q, k_pages, v_pages, page_table, k_tail, v_tail, prefix_len,
                   tail_len, softcap=softcap, scale=scale, window=window,
                   k_scale_tab=k_scale_tab, v_scale_tab=v_scale_tab)


def _launch(route, q, k_pages, v_pages, page_table, k_tail, v_tail, prefix_len, tail_len, *,
            softcap, scale, window, k_scale_tab, v_scale_tab):
    """Check the inputs and launch the entry of ``route`` (see ``_ENTRY``),
    counting it."""
    quantized = route in _FLAGS
    tc = route in (torch.bfloat16, "q_tc")
    _check_inputs(q, k_pages, v_pages, page_table, k_tail, v_tail,
                  prefix_len, tail_len, k_scale_tab, v_scale_tab, tc,
                  TC_HEAD_DIMS if tc else HEAD_DIMS)
    build.refuse_grad("paged_flash_prefill", q, k_pages, v_pages, k_tail, v_tail)
    b, hq, st, d = q.shape
    hkv, num_pages, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    if scale is None:
        scale = 1.0 / d**0.5
    o = torch.empty_like(q)
    global launches, launches_tc, launches_q, launches_q_tc
    pointers = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    if quantized:
        launches_q += 1
        launches_q_tc += int(tc)
        pointers += (k_scale_tab.data_ptr(), v_scale_tab.data_ptr())
    else:
        launches += 1
        launches_tc += int(tc)
    fp8 = int(k_pages.dtype == torch.float8_e4m3fn)
    flags = {"q": (int(q.dtype == torch.bfloat16), fp8), "q_tc": (fp8,)}.get(route, ())
    status = _kernel(route)(
        *pointers, page_table.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
        prefix_len.data_ptr(), tail_len.data_ptr(), o.data_ptr(),
        b, hq, hkv, st, num_pages, ps, mp, d, *flags,
        float(scale), int(window or 0), float(softcap or 0.0), build.stream_of(q),
    )
    build.check(status, _ENTRY[route])
    return o


def gather_stripes(k_pages, v_pages, page_table, k_tail, v_tail, prefix_len, *,
                   k_scales=None, v_scales=None):
    """The gather route's dense K and V, each ``(B, Hkv, mp * ps + St, D)``
    in the tail's dtype: position ``j`` of row ``b`` holds the prefix's
    key ``j`` for ``j < prefix_len[b]`` (read through the table; a
    quantized pool's codes times their page's scale, in float32, then
    rounded to the tail's dtype once) and the tail's row ``j -
    prefix_len[b]`` after it; positions past the tail repeat its last row.
    ``prefix_len[b]`` is at most ``mp * ps``."""
    b, hkv, st, d = k_tail.shape
    ps = k_pages.shape[2]
    sp = page_table.shape[1] * ps
    flat = page_table.reshape(-1).long()
    pos = torch.arange(sp + st, device=k_tail.device)
    plen = prefix_len.to(k_tail.device).long()[:, None]
    src = torch.where(pos < plen, pos, sp + (pos - plen).clamp(max=st - 1))      # (B, K)
    src = src[:, None, :, None].expand(b, hkv, sp + st, d)
    out = []
    for pages, scale_tab, tail in ((k_pages, k_scales, k_tail), (v_pages, v_scales, v_tail)):
        g = quant.index_pages(pages, (slice(None), flat))          # (Hkv, B * mp, ps, D)
        if scale_tab is not None:
            g = g.float() * scale_tab[:, flat][..., None, None]
        g = g.to(tail.dtype).reshape(hkv, b, sp, d).transpose(0, 1)
        out.append(torch.gather(torch.cat([g, tail], dim=2), 2, src))
    return out


def paged_prefill_gather(q, k_pages, v_pages, page_table, k_tail, v_tail, prefix_len,
                         tail_len, *, softcap=None, scale=None, window=None, k_scales=None,
                         v_scales=None) -> torch.Tensor:
    """:func:`paged_flash_prefill`'s function by the gather route: the
    prefix and the tail packed into dense stripes (:func:`gather_stripes`),
    then K1 with ``q_offset = prefix_len`` and ``kv_len = prefix_len +
    tail_len``; rows at or past ``tail_len`` give exact zeros. On CUDA
    tensors the attention is K1's kernel (counted as K1's launches), on CPU
    tensors its plain version."""
    k_scale_tab, v_scale_tab = k_scales, v_scales
    quant.scale_pair(k_scale_tab, v_scale_tab)
    k, v = gather_stripes(k_pages, v_pages, page_table, k_tail, v_tail, prefix_len,
                          k_scales=k_scale_tab, v_scales=v_scale_tab)
    o, _ = flash_attention_fwd(q.contiguous(), k, v, causal=True, window=window,
                               softcap=softcap, scale=scale, q_offset=prefix_len,
                               kv_len=prefix_len + tail_len)
    rows = torch.arange(q.shape[2], device=q.device)
    live = rows[None, :] < tail_len.to(q.device)[:, None]
    return torch.where(live[:, None, :, None], o, torch.zeros_like(o))
