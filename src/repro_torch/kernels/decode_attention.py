"""K7 and K8: dense flash-decode, one-pass and split-K — the CUDA kernels
and their plain version.

Port of ``repro.kernels.decode_attention.flash_decode`` and
``_flash_decode_split`` (the Pallas bodies ``_decode_kernel`` and
``_decode_split_kernel``): one new token per sequence against a dense
per-slot stripe ``(B, Hkv, Smax, D)``. The kernels are in
``csrc/dense_decode.cu``, one block per (b, kv head), or per (b, kv head,
split), serving the whole GQA group from each stripe row it loads; the
split states merge in the combine kernel K4 uses. bf16 runs
``dense_decode_tc`` / ``dense_decode_split_tc`` on the tensor cores: a
producer thread keeps 64-row K/V tiles in flight by TMA through a 128 KB
ring, four warps take whole tiles in turn through ``mma.sync`` and merge
once at the end (decode is bound by memory: the ring is what lets a block
pull its share). float32 runs ``dense_decode`` /
``dense_decode_split`` on the CUDA cores in float32 (the tensor cores would
round it to TF32). :func:`flash_decode` launches the one for its dtype on
CUDA tensors and runs :func:`flash_decode_plain` — the same chunk walk,
relevance gate and split combine, written with ``decode_common`` — for CPU
tensors.

The walk goes in chunks of ``chunk`` positions (from the plan,
``kernels.plan``); split ranges are chunk-granular, from
``cache.layout.decode_split_ranges`` as in the JAX package. The stripe may
be a view cut to the live width (the serving backend passes one): the rows
of one head must be contiguous, the batch and head strides are free (for
bf16, multiples of 8 elements: the tensor map's 16 bytes).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.cache.layout import decode_split_ranges
from repro_torch.kernels import build, decode_common

HEAD_DIMS = (64, 128)
MAX_GROUP = 32
#: Stripe rows staged per step (DC_BT in csrc/decode_common.cuh, tc::BT in
#: csrc/dense_decode.cu): the block the plan's chunk rule tiles by.
STAGE = 64

#: Launches since the last reset: one-pass (K7) and split-K (K8; each
#: launch is the split kernel followed by its combine), of either dtype;
#: the ``_tc`` keys count the bf16 tensor-core kernel's alone.
launches = {"one_pass": 0, "split": 0, "one_pass_tc": 0, "split_tc": 0}


def flash_decode_plain(q, k_cache, v_cache, lengths, *, softcap=None, scale=None,
                       window=None, chunk: int = STAGE, num_splits: int = 1
                       ) -> torch.Tensor:
    """What K7/K8 compute, in plain PyTorch: per split range of chunks, an
    online-softmax walk over the relevant chunks, then the combine."""
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    group = hq // hkv
    if scale is None:
        scale = 1.0 / d**0.5
    chunk = min(chunk, smax)
    if smax % chunk:
        raise ValueError(f"cache length {smax} is not a multiple of chunk {chunk} (ops pads)")
    num_chunks = smax // chunk
    qg = q.float().reshape(b * hkv, group, d)
    ln = lengths.to(q.device).long().repeat_interleave(hkv)    # (B*Hkv,)
    states = []
    for start, end in decode_split_ranges(num_chunks, num_splits):
        acc = torch.zeros((b * hkv, group, d), device=q.device)
        m = torch.full((b * hkv, group, 1), decode_common.NEG_INF, device=q.device)
        l = torch.zeros((b * hkv, group, 1), device=q.device)
        for c in range(start, end):
            live = decode_common.chunk_relevant(c * chunk, chunk, ln, window)
            if decode_common.dead_block(live):
                continue
            sl = slice(c * chunk, (c + 1) * chunk)
            k = k_cache[:, :, sl].reshape(b * hkv, chunk, d)
            v = v_cache[:, :, sl].reshape(b * hkv, chunk, d)
            acc1, m1, l1 = decode_common.accumulate_kv_block(
                qg, k, v, acc, m, l, scale=scale, softcap=softcap, window=window,
                block_start=c * chunk, length=ln)
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
_ENTRY = {(torch.float32, False): "dense_decode", (torch.float32, True): "dense_decode_split",
          (torch.bfloat16, False): "dense_decode_tc",
          (torch.bfloat16, True): "dense_decode_split_tc"}
_fns = {}


def _kernel(dtype, split: bool):
    fn = _fns.get((dtype, split))
    if fn is None:
        P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        if split:
            args = [P] * 8 + [I] * 4 + [L, L] + [I] * 4 + [F, I, F, P]
        else:
            args = [P] * 5 + [I] * 4 + [L, L] + [I] * 2 + [F, I, F, P]
        fn = _fns[(dtype, split)] = build.bind("dense_decode", _ENTRY[(dtype, split)], args)
    return fn


def _check_inputs(q, k_cache, v_cache, lengths, chunk):
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q and the caches must share a dtype in {list(_DTYPES)}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous int32")
    b, hq, d = q.shape
    bk, hkv, smax, dk = k_cache.shape
    if v_cache.shape != k_cache.shape or dk != d or bk != b or lengths.shape != (b,):
        raise ValueError("cache / lengths shapes do not match q")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"GQA group Hq/Hkv={hq}/{hkv} unsupported")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if smax % chunk:
        raise ValueError(f"cache length {smax} is not a multiple of chunk {chunk} (ops pads)")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name}: the rows of one head must be contiguous")
    if v_cache.stride() != k_cache.stride():
        raise ValueError("k_cache and v_cache must share strides")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the caches must start 16-byte aligned (16-byte loads, tensor maps)")
    if q.dtype == torch.bfloat16 and (k_cache.stride(0) % 8 or k_cache.stride(1) % 8):
        raise ValueError("bf16 caches: the batch and head strides must be multiples of 8 "
                         "elements (the tensor map's 16 bytes)")


def flash_decode(q, k_cache, v_cache, lengths, *, softcap=None, scale=None,
                 window=None, chunk: int = STAGE, num_splits: int = 1) -> torch.Tensor:
    """q (B, Hq, D); k/v_cache (B, Hkv, Smax, D), Smax a multiple of
    ``chunk`` (``ops.decode_attention`` pads); lengths (B,) int32. Returns
    (B, Hq, D).

    ``num_splits > 1`` runs split-K over :func:`decode_split_ranges` of the
    chunks (clamped to the chunk count). CUDA tensors launch the kernel of
    their dtype (bf16 on the tensor cores, float32 on the CUDA cores), CPU
    tensors take the plain version; under grad mode it raises: the kernels
    have no backward.
    """
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths, softcap=softcap,
                                  scale=scale, window=window, chunk=chunk,
                                  num_splits=num_splits)
    b, hq, d = q.shape
    chunk = min(int(chunk), k_cache.shape[2])
    _check_inputs(q, k_cache, v_cache, lengths, chunk)
    build.refuse_grad("flash_decode", q, k_cache, v_cache)
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / d**0.5
    num_chunks = smax // chunk
    ranges = decode_split_ranges(num_chunks, num_splits)
    out = torch.empty_like(q)
    strides = (k_cache.stride(0), k_cache.stride(1))
    common = (float(scale), int(window or 0), float(softcap or 0.0), build.stream_of(q))
    tc = q.dtype == torch.bfloat16
    if len(ranges) == 1:
        launches["one_pass"] += 1
        launches["one_pass_tc"] += int(tc)
        status = _kernel(q.dtype, False)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, hq, hkv, d, *strides, chunk, num_chunks, *common)
        build.check(status, _ENTRY[(q.dtype, False)])
        return out
    s = len(ranges)
    cps = ranges[0][1] - ranges[0][0]
    group = hq // hkv
    acc = torch.empty((b, hkv, s, group, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, s, group), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    launches["split"] += 1
    launches["split_tc"] += int(tc)
    status = _kernel(q.dtype, True)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq, hkv, d,
        *strides, chunk, num_chunks, s, cps, *common)
    build.check(status, _ENTRY[(q.dtype, True)])
    return out
