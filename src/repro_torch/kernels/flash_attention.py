"""K1: FlashAttention-2 forward — the CUDA kernel, its plain version, and
the NUMA-aware launch configuration.

Port of ``repro.kernels.flash_attention.flash_attention_fwd`` (the two
Pallas bodies ``_fwd_resident_kernel`` and ``_fwd_stream_kernel``). The
kernels are in ``csrc/flash_attention.cu``: bf16 runs ``fa2_fwd_tc`` on the
tensor cores (``wgmma`` fed by TMA), float32 ``fa2_fwd`` on the CUDA cores
in float32 (the tensor cores would round it to TF32).
:func:`flash_attention_fwd` launches the one for its dtype on CUDA tensors
and runs :func:`flash_attention_fwd_plain` for CPU tensors.

Both take per-row query offsets: ``q_offset`` places query row ``i`` of
batch row ``b`` at position ``q_offset[b] + i`` against a longer K/V, and
``kv_len`` masks keys at or past ``kv_len[b]`` (each an int or a ``(B,)``
tensor). That is the dense extend (``ops.flash_attention(q_offset=)``, the
JAX package's ``ref.attention(q_offset=)``) and the paged extend's gather
route (``ops.paged_prefill_attention`` under ``impl="gather"``).

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

:func:`hbm_block_fetches` counts the bytes a K1 launch loads from memory
under a mapping (the plan's tie-break between launches its analytic model
prices alike).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import swizzle
from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF, _expand_kv, _softcap, score_blocks

HEAD_FIRST = "head_first"
BLOCK_FIRST = "block_first"

#: Tile sizes of the float32 kernel (PF_BM / PF_BN in csrc/prefill_tile.cuh);
#: ``ops.flash_attention`` pads sequences to them. The bf16 kernel tiles by
#: 128 (ptc::BM / ptc::Smem<D>::BN in csrc/prefill_tc.cuh; 64 keys at head
#: dim 256) and takes ragged lengths as they are.
BLOCK_M = 64
BLOCK_N = 64
#: Head dims of the float32 kernels (K1, and K5 / K6, which share the check).
HEAD_DIMS = (64, 128)
#: Head dims of the bf16 tensor-core kernels (K1, K5 and K6): 256 too (the
#: gemma family).
TC_HEAD_DIMS = (64, 128, 256)
#: Tile sizes of the bf16 tensor-core kernel (ptc::BM / ptc::Smem<D>::BN);
#: the key tile at head dim 256.
TC_BLOCK_M = 128
TC_BLOCK_N = 128
TC_BLOCK_N_D256 = 64

#: Launches of either CUDA kernel since the last reset; ``launches_tc``
#: counts those of the bf16 tensor-core kernel alone.
launches = 0
launches_tc = 0


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


def tiles(dtype_bytes: int, head_dim: int = 128) -> Tuple[int, int]:
    """K1's fixed (block_m, block_n) for an element size and head dim: 128
    x 128 for bf16 (the tensor-core kernel; 128 x 64 at head dim 256), 64 x
    64 for float32."""
    if dtype_bytes != 2:
        return BLOCK_M, BLOCK_N
    return TC_BLOCK_M, TC_BLOCK_N_D256 if head_dim == 256 else TC_BLOCK_N


def hbm_block_fetches(*, batch: int, num_q_heads: int, num_kv_heads: int,
                      seq_q: int, seq_kv: int, head_dim: int, dtype_bytes: int = 2,
                      mapping: MappingConfig = MappingConfig(), causal: bool = True,
                      window: Optional[int] = None) -> dict:
    """Bytes a K1 launch loads from memory under ``mapping``: each q block's
    Q rows once, then each (q block, live KV tile)'s K and V rows, at the
    kernel's fixed tiles (:func:`tiles`); the rows past a sequence's end
    that TMA fills with zeros are not read. The Hopper form of the JAX
    package's count, which differs in one point: a Pallas pipeline skips
    the copy of a block revisited at consecutive grid steps (so there the
    sawtooth traversal and a resident K/V save copies), while a TMA
    pipeline loads every tile it walks. The count is therefore the same for
    every order and traversal: what an order changes is which loads the L2
    serves, which the analytic model (``core.perf_model.estimate``) prices."""
    if mapping.order not in (HEAD_FIRST, BLOCK_FIRST):
        raise ValueError(f"unknown order {mapping.order!r}")
    if mapping.traversal not in swizzle.TRAVERSALS:
        raise ValueError(f"unknown traversal {mapping.traversal!r}")
    bm, bn = tiles(dtype_bytes, head_dim)
    row = head_dim * dtype_bytes
    kv_rows = 0
    for q0 in range(0, seq_q, bm):
        # [n_lo, n_hi): the q block's KV tiles (kv_tile_range, csrc/common.cuh).
        n_hi = -(-seq_kv // bn)
        if causal:
            n_hi = min(n_hi, (q0 + bm + bn - 1) // bn)
        n_lo = max(q0 - window + 1, 0) // bn if window else 0
        kv_rows += max(0, min(n_hi * bn, seq_kv) - n_lo * bn)
    q_traffic = batch * num_q_heads * seq_q * row
    kv_traffic = 2 * batch * num_q_heads * kv_rows * row
    ideal = batch * (2 * num_kv_heads * seq_kv + num_q_heads * seq_q) * row
    total = kv_traffic + q_traffic
    return {
        "kv_bytes": kv_traffic,
        "q_bytes": q_traffic,
        "total_bytes": total,
        "ideal_bytes": ideal,
        "reuse_efficiency": ideal / total if total else 0.0,
    }


def _per_row(x, batch: int, default: int, device, dtype=torch.long) -> torch.Tensor:
    """An int, a ``(B,)`` tensor or None (``default``) as a contiguous (B,)
    tensor of ``dtype`` on ``device``."""
    if x is None:
        x = default
    if isinstance(x, torch.Tensor):
        if x.shape != (batch,):
            raise ValueError(f"per-row argument of shape {tuple(x.shape)}, expected ({batch},)")
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.full((batch,), int(x), dtype=dtype, device=device)


def flash_attention_fwd_plain(q, k, v, *, causal=True, window=None,
                              softcap=None, scale=None, kv_len=None, q_offset=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function K1 computes, in plain PyTorch: ``(o, lse)``. Query row
    ``i`` of batch row ``b`` sits at position ``q_offset[b] + i``; keys at
    or past ``kv_len[b]`` are masked (each an int, a ``(B,)`` tensor or
    None: offset 0, every key). A fully masked row gives o = 0 and
    lse = -1e30, as the kernel does. Past ``ref.PLAIN_SCORE_ELEMS`` scores
    it runs by blocks of batch rows and kv heads (``ref.score_blocks``)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    blocks = score_blocks(b, hkv, group, sq, skv)
    if blocks is None:
        return _fwd_plain(q, k, v, causal, window, softcap, scale, kv_len, q_offset)
    off = _per_row(q_offset, b, 0, q.device)
    live = _per_row(kv_len, b, skv, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    for bi, h0, h1 in blocks:
        r, hs = slice(bi, bi + 1), slice(h0 * group, h1 * group)
        o[r, hs], lse[r, hs] = _fwd_plain(q[r, hs], k[r, h0:h1], v[r, h0:h1], causal, window,
                                          softcap, scale, live[r], off[r])
    return o, lse


def _fwd_plain(q, k, v, causal, window, softcap, scale, kv_len, q_offset):
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = 1.0 / d**0.5
    kk = _expand_kv(k, hq // k.shape[1]).float()
    vv = _expand_kv(v, hq // v.shape[1]).float()
    s = _softcap(torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale, softcap)
    off = _per_row(q_offset, b, 0, q.device)[:, None, None, None]
    live = _per_row(kv_len, b, skv, q.device)[:, None, None, None]
    rows = off + torch.arange(sq, device=q.device)[:, None]          # (B, 1, Sq, 1)
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = cols < live
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
#: dtype -> the C entry point of K1 that takes it.
_ENTRY = {torch.float32: "fa2_fwd", torch.bfloat16: "fa2_fwd_tc"}
_fns = {}


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = _fns[dtype] = build.bind("flash_attention", _ENTRY[dtype],
                                      [P] * 7 + [I] * 7 + [F, I, I, F, I, I, P])
    return fn


def _check_inputs(q, k, v, head_dims=None):
    """Shapes, types and layout a K1 / K5 / K6 launch takes; ``head_dims``
    (default: K1's for q's dtype) the head dims its kernel is built for."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share a dtype in {list(_DTYPES)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} not divisible by Hkv={k.shape[1]}")
    if head_dims is None:
        head_dims = TC_HEAD_DIMS if q.dtype == torch.bfloat16 else HEAD_DIMS
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not in {head_dims} for {q.dtype} on the card")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def flash_attention_fwd(q, k, v, *, mapping: MappingConfig = MappingConfig(),
                        causal=True, window=None, softcap=None, scale=None,
                        kv_len=None, q_offset=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FA2 forward. q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (o, lse).

    CUDA tensors launch the K1 kernel of their dtype (bf16 on the tensor
    cores, float32 on the CUDA cores); CPU tensors take the plain version.
    ``kv_len`` masks padding keys and ``q_offset`` places the queries
    after a prefix, each an int or a ``(B,)`` tensor (see
    :func:`flash_attention_fwd_plain`). On CUDA tensors that need a
    gradient it raises: the differentiable route is ``ops.flash_attention``.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, window=window,
                                         softcap=softcap, scale=scale, kv_len=kv_len,
                                         q_offset=q_offset)
    _check_inputs(q, k, v)
    # Both kernels read rows 16 bytes at a time, and TMA needs 16-byte
    # aligned tensors; a tensor map has no empty dimension.
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start at 16-byte aligned addresses")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention_fwd takes at least one query and one key")
    build.refuse_grad("flash_attention_fwd", q, k, v)
    if mapping.order not in (HEAD_FIRST, BLOCK_FIRST):
        raise ValueError(f"unknown order {mapping.order!r}")
    if mapping.traversal not in swizzle.TRAVERSALS:
        raise ValueError(f"unknown traversal {mapping.traversal!r}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / d**0.5
    # An int kv_len rides the scalar argument, a per-row one the kernel's
    # (B,) array; offset 0 is a null array.
    per_row_len = isinstance(kv_len, torch.Tensor)
    kv_lens = _per_row(kv_len, b, skv, q.device, torch.int32) if per_row_len else None
    kv_len = skv if kv_len is None or per_row_len else int(kv_len)
    q_off = _per_row(q_offset, b, 0, q.device, torch.int32) if (
        isinstance(q_offset, torch.Tensor) or q_offset) else None
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    global launches, launches_tc
    launches += 1
    if q.dtype == torch.bfloat16:
        launches_tc += 1
    status = _kernel(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        0 if q_off is None else q_off.data_ptr(),
        0 if kv_lens is None else kv_lens.data_ptr(),
        b, hq, hkv, sq, skv, kv_len, d, float(scale), int(bool(causal)),
        int(window or 0), float(softcap or 0.0),
        0 if mapping.order == HEAD_FIRST else 1,
        int(mapping.traversal == swizzle.SAWTOOTH), build.stream_of(q),
    )
    build.check(status, _ENTRY[q.dtype])
    return o, lse
