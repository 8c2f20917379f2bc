"""K5 (dQ) and K6 (dK, dV): the FlashAttention-2 backward — the CUDA
kernels and their plain version.

Port of ``repro.kernels.flash_attention_bwd.flash_attention_bwd`` (the
Pallas kernels ``_dq_kernel`` and ``_dkv_kernel``). The kernels are
``csrc/flash_attention_bwd.cu``: bf16 runs ``fa2_bwd_dq_tc`` /
``fa2_bwd_dkv_tc`` on the tensor cores (``wgmma`` fed by TMA; P and dS
rounded to bf16 before their products), float32 ``fa2_bwd_dq`` /
``fa2_bwd_dkv`` on the CUDA cores in float32. Each pair is launched by its
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
from typing import Optional, Tuple

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
        _fns[name] = build.bind("flash_attention_bwd", name,
                                [P] * 6 + outs + [I] * 7 + [F, I, I, F, I, P])
    return _fns[name]


def _check_bwd_inputs(q, k, v, do, lse, delta, mapping):
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
    runs on the tensor cores, float32 on the CUDA cores; inputs must be
    contiguous and 16-byte aligned."""
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
                            kv_len: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on CUDA tensors: (dK, dV), each (B, Hkv, Skv, D) in k's dtype and
    summed over the GQA group inside the kernel."""
    _check_bwd_inputs(q, k, v, do, lse, delta, mapping)
    build.refuse_grad("flash_attention_bwd_dkv", q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _count("dkv", q.dtype)
    build.check(_kernel("dkv", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_args(q, k, mapping, causal, window, softcap, scale, kv_len)),
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
