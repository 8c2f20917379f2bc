"""K1: FlashAttention-2 forward — the CUDA kernel, its plain version, and
the NUMA-aware launch configuration.

Port of ``repro.kernels.flash_attention.flash_attention_fwd`` (the two
Pallas bodies ``_fwd_resident_kernel`` and ``_fwd_stream_kernel``). The
kernel is ``csrc/flash_attention.cu``; :func:`flash_attention_fwd` launches
it for CUDA tensors and runs :func:`flash_attention_fwd_plain` for CPU
tensors.

``MappingConfig`` holds the two fields of the paper's schedule that have a
launch form on Hopper: ``order`` (how ``blockIdx`` decodes into
(b, h, q block): head-first keeps one KV head's blocks consecutive, the
paper's locality) and ``traversal`` (linear or sawtooth KV-tile order).
The paper's naive/swizzled variants differ only in VMEM residency and
megacore grid semantics, which an SM does not have (no room for a resident
K/V; every block already runs in parallel). So ``PAPER_MAPPINGS`` keeps the
four names as aliases of the two Hopper orders: ``naive_head_first`` and
``swizzled_head_first`` are one launch, as are the two block-first names.
No mapping changes an output.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import swizzle
from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF, _expand_kv, _softcap

HEAD_FIRST = "head_first"
BLOCK_FIRST = "block_first"

#: Tile sizes of the CUDA kernel (PF_BM / PF_BN in csrc/prefill_tile.cuh).
BLOCK_M = 64
BLOCK_N = 64
HEAD_DIMS = (64, 128)

#: Launches of the CUDA kernel since the last reset.
launches = 0


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Launch schedule of the FA2 forward (see the module docstring)."""

    order: str = HEAD_FIRST
    traversal: str = swizzle.LINEAR


#: The paper's four schedule names, aliases of the two Hopper launch orders.
PAPER_MAPPINGS = {
    "swizzled_head_first": MappingConfig(order=HEAD_FIRST),
    "naive_head_first": MappingConfig(order=HEAD_FIRST),
    "swizzled_block_first": MappingConfig(order=BLOCK_FIRST),
    "naive_block_first": MappingConfig(order=BLOCK_FIRST),
}


def flash_attention_fwd_plain(q, k, v, *, causal=True, window=None,
                              softcap=None, scale=None,
                              kv_len: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function K1 computes, in plain PyTorch: ``(o, lse)`` with keys at
    or past ``kv_len`` masked. A fully masked row gives o = 0 and
    lse = -1e30, as the kernel does."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if kv_len is None:
        kv_len = skv
    if scale is None:
        scale = 1.0 / d**0.5
    kk = _expand_kv(k, hq // k.shape[1]).float()
    vv = _expand_kv(v, hq // v.shape[1]).float()
    s = _softcap(torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale, softcap)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = cols < kv_len
    if causal:
        mask = mask & (cols <= rows)
    if window is not None and window > 0:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / torch.where(l == 0, 1.0, l), vv)
    lse = torch.where(l[..., 0] == 0, torch.full_like(l[..., 0], NEG_INF),
                      m[..., 0] + torch.log(torch.where(l == 0, 1.0, l))[..., 0])
    return o.to(q.dtype), lse


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _fn = build.bind("flash_attention", "fa2_fwd",
                         [P, P, P, P, P] + [I] * 7 + [F, I, I, F, I, I, I, P])
    return _fn


def _check_inputs(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share a dtype in {list(_DTYPES)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} not divisible by Hkv={k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def flash_attention_fwd(q, k, v, *, mapping: MappingConfig = MappingConfig(),
                        causal=True, window=None, softcap=None, scale=None,
                        kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FA2 forward. q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (o, lse).

    CUDA tensors launch the K1 kernel; CPU tensors take the plain version.
    ``kv_len`` masks padding keys. On CUDA tensors that need a gradient it
    raises: the differentiable route is ``ops.flash_attention``.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, window=window,
                                         softcap=softcap, scale=scale, kv_len=kv_len)
    _check_inputs(q, k, v)
    build.refuse_grad("flash_attention_fwd", q, k, v)
    if mapping.order not in (HEAD_FIRST, BLOCK_FIRST):
        raise ValueError(f"unknown order {mapping.order!r}")
    if mapping.traversal not in swizzle.TRAVERSALS:
        raise ValueError(f"unknown traversal {mapping.traversal!r}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / d**0.5
    kv_len = skv if kv_len is None else int(kv_len)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    global launches
    launches += 1
    status = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, hq, hkv, sq, skv, kv_len, d, float(scale), int(bool(causal)),
        int(window or 0), float(softcap or 0.0),
        0 if mapping.order == HEAD_FIRST else 1,
        int(mapping.traversal == swizzle.SAWTOOTH), _DTYPES[q.dtype],
        build.stream_of(q),
    )
    build.check(status, "fa2_fwd")
    return o, lse
