"""K5 (dQ) and K6 (dK, dV): the FlashAttention-2 backward — the CUDA
kernels and their plain version.

Port of ``repro.kernels.flash_attention_bwd.flash_attention_bwd`` (the
Pallas kernels ``_dq_kernel`` and ``_dkv_kernel``). The kernels are
``csrc/flash_attention_bwd.cu``: bf16 runs ``fa2_bwd_dq_tc`` /
``fa2_bwd_dkv_tc`` on the tensor cores (``wgmma`` fed by TMA; P and dS
rounded to bf16 before their products) at head_dim 64, 128 and 256 (the
gemma family: both warpgroups of a block on 64 shared rows, each
accumulating half of D's columns; causal K5 issues its longest walks first,
and K6 splits walks too long for the card's blocks into parts summed in a
fixed order, :func:`dkv_parts`), float32 ``fa2_bwd_dq`` /
``fa2_bwd_dkv`` on the CUDA cores in float32 at head_dim 64 and 128. Each pair is launched by its
own wrapper (:func:`flash_attention_bwd_dq`, :func:`flash_attention_bwd_dkv`);
:func:`flash_attention_bwd` launches both for CUDA tensors and runs
:func:`flash_attention_bwd_plain` for CPU tensors. ``delta = rowsum(dO * O)``
is computed here in PyTorch, outside the kernels, as the JAX package
computes it in XLA outside Pallas.

The ``MappingConfig`` is K1's: ``order`` decodes each kernel's ``blockIdx``
head-first or block-first (the paper's schedule choice for the backward
pass); ``traversal`` belongs to the forward and is not read here, as in the
JAX package. No order changes an output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    BLOCK_FIRST,
    HEAD_FIRST,
    MappingConfig,
    _check_inputs,
)
from repro_torch.kernels.ref import NEG_INF, _expand_kv, _softcap

#: Launches of K5 ("dq") and K6 ("dkv") since the last reset, either dtype;
#: "dq_tc" / "dkv_tc" count those of the bf16 tensor-core kernels alone.
launches = {"dq": 0, "dkv": 0, "dq_tc": 0, "dkv_tc": 0}


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True, window=None,
                              softcap=None, scale=None,
                              kv_len: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function K5 and K6 compute, in plain PyTorch: ``(dq, dk, dv)``.

    p is recomputed from the saved ``lse``; ``ds = p (dp - delta)``, times
    ``1 - (s_capped / softcap)^2`` with a softcap; rows whose lse is at most
    ``NEG_INF / 2`` (fully masked) contribute nothing; dK and dV are summed
    over the GQA group."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if kv_len is None:
        kv_len = skv
    if scale is None:
        scale = 1.0 / d**0.5
    qf, dof = q.float(), do.float()
    kk = _expand_kv(k, group).float()
    vv = _expand_kv(v, group).float()
    s = _softcap(torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale, softcap)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = cols < kv_len
    if causal:
        mask = mask & (cols <= rows)
    if window is not None and window > 0:
        mask = mask & (cols > rows - window)
    mask = mask & (lse > NEG_INF / 2)[..., None]
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    ds = p * (dp - delta)
    if softcap is not None and softcap > 0:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kk)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, hkv, group, skv, d).sum(2)
    dv = dv.reshape(b, hkv, group, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: (kernel, dtype) -> the C entry point that takes it.
_ENTRY = {("dq", torch.float32): "fa2_bwd_dq", ("dq", torch.bfloat16): "fa2_bwd_dq_tc",
          ("dkv", torch.float32): "fa2_bwd_dkv", ("dkv", torch.bfloat16): "fa2_bwd_dkv_tc"}
_fns = {}


def _kernel(which: str, dtype):
    name = _ENTRY[which, dtype]
    if name not in _fns:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        outs = [P] if which == "dq" else [P, P]
        split = [I, P] if name == "fa2_bwd_dkv_tc" else []   # parts, scratch
        _fns[name] = build.bind("flash_attention_bwd", name,
                                [P] * 6 + outs + [I] * 7 + [F, I, I, F, I, P] + split)
    return _fns[name]


# -- K6's split at head_dim 256 ------------------------------------------------

#: Rows of a K6 block and of a q tile of its walk at head_dim 256.
D256_ROWS = 64
#: K6's part counts at head_dim 256, fewest first, and the longest part
#: :func:`dkv_parts` accepts against the mean part.
DKV_PARTS = (1, 2, 4, 8)
DKV_BALANCE = 1.15


def dkv_walks(sq: int, skv: int, group: int, *, causal=True, window=None,
              kv_len: Optional[int] = None) -> List[int]:
    """Tiles each 64-row kv block of K6 walks at head_dim 256, in block
    order: the GQA group's q heads times the 64-row q tiles its keys see
    (``dkv_tiles256`` in csrc/flash_attention_bwd.cu)."""
    live = skv if kv_len is None else min(skv, int(kv_len))
    nm = -(-sq // D256_ROWS)
    out = []
    for nb in range(-(-skv // D256_ROWS)):
        c0 = nb * D256_ROWS
        m_lo = c0 // D256_ROWS if causal else 0
        m_hi = nm if c0 < live else 0
        if window is not None and window > 0:
            m_hi = min(m_hi, (c0 + D256_ROWS - 1 + window - 1) // D256_ROWS + 1)
        out.append(group * max(0, m_hi - m_lo))
    return out


def dkv_part_walks(walks: List[int], parts: int) -> List[int]:
    """The tiles each part walks, in launch order within one (b, kv head):
    block nb's walk cut into ranges of ceil(longest walk / parts) tiles, as
    the kernel cuts it (at least one part a block, as the kernel runs)."""
    chunk = max(1, -(-max(walks, default=0) // parts))
    return [min(chunk, n - p * chunk) if n else 0
            for n in walks for p in range(max(1, -(-n // chunk)))]


@functools.lru_cache(maxsize=256)
def dkv_parts(b: int, hq: int, hkv: int, sq: int, skv: int, *, causal=True, window=None,
              kv_len: Optional[int] = None, sms: int = 132) -> int:
    """K6's part count at head_dim 256: one where its b * hkv * ceil(skv /
    64) blocks fill the ``sms`` SMs (one block an SM: a block takes 226 KB
    of shared memory; gemma2-2b's train shape has 512); else the fewest of
    :data:`DKV_PARTS` whose longest part walks at most :data:`DKV_BALANCE`
    times the mean part, the most if none does."""
    walks = dkv_walks(sq, skv, hq // hkv, causal=causal, window=window, kv_len=kv_len)
    if b * hkv * len(walks) >= sms:
        return 1
    for parts in DKV_PARTS:
        lengths = dkv_part_walks(walks, parts)
        if max(lengths) <= DKV_BALANCE * sum(lengths) / len(lengths):
            return parts
    return DKV_PARTS[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_bwd_inputs(q, k, v, do, lse, delta, mapping):
    # K1's head dims: 64, 128 and 256 in bf16, 64 and 128 in float32.
    _check_inputs(q, k, v)
    # Both routes read rows 16 bytes at a time, and TMA needs 16-byte
    # aligned tensors; a tensor map has no empty dimension.
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("q, k, v and do must start at 16-byte aligned addresses")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("the FA2 backward takes at least one query and one key")
    b, hq, sq, _ = q.shape
    for name, t, dtype, shape in (("do", do, q.dtype, q.shape),
                                  ("lse", lse, torch.float32, (b, hq, sq)),
                                  ("delta", delta, torch.float32, (b, hq, sq))):
        if t.device != q.device or t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mapping.order not in (HEAD_FIRST, BLOCK_FIRST):
        raise ValueError(f"unknown order {mapping.order!r}")


def _args(q, k, mapping, causal, window, softcap, scale, kv_len):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    return (b, hq, hkv, sq, skv, skv if kv_len is None else int(kv_len), d,
            float(1.0 / d**0.5 if scale is None else scale), int(bool(causal)),
            int(window or 0), float(softcap or 0.0),
            0 if mapping.order == HEAD_FIRST else 1, build.stream_of(q))


def _count(which: str, dtype) -> None:
    launches[which] += 1
    if dtype == torch.bfloat16:
        launches[which + "_tc"] += 1


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *,
                           mapping: MappingConfig = MappingConfig(), causal=True,
                           window=None, softcap=None, scale=None,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """K5 on CUDA tensors: dQ (B, Hq, Sq, D) in q's dtype, from the forward's
    ``lse`` and ``delta = rowsum(dO * O)`` (both (B, Hq, Sq) float32). bf16
    runs on the tensor cores (D 64, 128 or 256), float32 on the CUDA cores
    (D 64 or 128); inputs must be contiguous and 16-byte aligned."""
    _check_bwd_inputs(q, k, v, do, lse, delta, mapping)
    build.refuse_grad("flash_attention_bwd_dq", q, k, v, do)
    dq = torch.empty_like(q)
    _count("dq", q.dtype)
    build.check(_kernel("dq", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        *_args(q, k, mapping, causal, window, softcap, scale, kv_len)),
        _ENTRY["dq", q.dtype])
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *,
                            mapping: MappingConfig = MappingConfig(), causal=True,
                            window=None, softcap=None, scale=None,
                            kv_len: Optional[int] = None, parts: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on CUDA tensors: (dK, dV), each (B, Hkv, Skv, D) in k's dtype and
    summed over the GQA group inside the kernel.

    bf16 at head_dim 256 splits each kv block's walk into ``parts`` (default
    :func:`dkv_parts` of the shapes and the card's SM count): the parts
    write float32 sums to a scratch tensor, freed on return, which a second
    kernel of the same call adds in part order. Every other route takes one
    part."""
    _check_bwd_inputs(q, k, v, do, lse, delta, mapping)
    build.refuse_grad("flash_attention_bwd_dkv", q, k, v, do)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    split = q.dtype == torch.bfloat16 and d == 256
    if parts is not None and (parts < 1 or (parts > 1 and not split)):
        raise ValueError(f"K6 splits its walk only in bf16 at head_dim 256; got {parts} parts "
                         f"at {q.dtype} head_dim {d}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    extra = ()
    scratch = None
    if split:
        if parts is None:
            parts = dkv_parts(b, hq, hkv, sq, skv, causal=bool(causal), window=window,
                              kv_len=kv_len, sms=_sm_count(q.device.index))
        if parts > 1:
            scratch = torch.empty((b * hkv, -(-skv // D256_ROWS), parts, 2, D256_ROWS, d),
                                  dtype=torch.float32, device=q.device)
        extra = (parts, 0 if scratch is None else scratch.data_ptr())
    elif q.dtype == torch.bfloat16:
        extra = (1, 0)
    _count("dkv", q.dtype)
    build.check(_kernel("dkv", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_args(q, k, mapping, causal, window, softcap, scale, kv_len), *extra),
        _ENTRY["dkv", q.dtype])
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *,
                        mapping: MappingConfig = MappingConfig(), causal=True,
                        window=None, softcap=None, scale=None,
                        kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FA2 backward: ``(dq, dk, dv)`` for the forward ``(o, lse)`` of q
    (B, Hq, Sq, D), k / v (B, Hkv, Skv, D) and the output gradient ``do``.

    CUDA tensors launch K5 and K6; CPU tensors take the plain version."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale, kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise ValueError(f"o must match q: {q.dtype} {tuple(q.shape)} on {q.device}")
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, mapping=mapping, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, mapping=mapping, **kw)
    return dq, dk, dv
