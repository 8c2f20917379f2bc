"""Quantized KV pages: int8 / fp8 codes plus one float32 scale per
(kv head, physical page).

The port's copy of ``repro.cache.quant``, in PyTorch, with the same names
and the same arithmetic. A quantized pool stores 1-byte codes
``(Hkv, P, page_size, D)`` and, for K and V each, a ``(Hkv, P)`` float32
scale table indexed by physical page id like the pool itself. The kernels
widen the codes to float32 and multiply by the page's scale where they
load them (``kernels/paged_decode_attention.py``,
``kernels/paged_prefill_attention.py``).

Symmetric schemes, no zero point:

  * ``int8``: codes in [-127, 127], ``scale = amax / 127``;
  * ``fp8``: ``torch.float8_e4m3fn`` codes, ``scale = amax / 448`` (the
    e4m3 largest normal);
  * ``fp32``: the unquantized pool, in the model's compute dtype; no scales.

Both encodings round half to even, as ``jnp.round`` and the JAX cast do.
Writes quantize per page with rescale-on-append: a page's scale is the
running amax of what was written into it, and a louder new row shrinks the
page's existing codes by ``old / new`` (re-encoded). Copy-on-write copies
codes verbatim and duplicates the scale entry (:func:`cow_scales`).

Unlike the JAX package, the write paths update the pool and the scale
table in place (a captured CUDA graph keeps reading the same tensors) and
return them. float8 tensors are indexed and written through a ``uint8``
view: index copies are not implemented for float8 on every build.
"""

from __future__ import annotations

import torch

__all__ = [
    "KV_DTYPES",
    "QMAX",
    "append_rows",
    "cow_scales",
    "dequantize_pages",
    "index_pages",
    "kv_dtype_of",
    "kv_itemsize",
    "put_pages",
    "quantize_pages",
    "scale_nbytes",
    "scale_pair",
    "scatter_pages",
    "storage_dtype",
    "validate_kv_dtype",
]

#: Supported pool storage formats, in the order the docs list them.
KV_DTYPES = ("fp32", "int8", "fp8")

#: Largest representable magnitude per quantized format (int8 symmetric
#: range; float8_e4m3fn largest normal).
QMAX = {"int8": 127.0, "fp8": 448.0}


def validate_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return kv_dtype


def storage_dtype(kv_dtype: str) -> torch.dtype:
    """The dtype the pool's codes are stored as (float32 for "fp32"; the
    engine stores an unquantized pool in the model's compute dtype)."""
    validate_kv_dtype(kv_dtype)
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    return torch.float32


def kv_itemsize(kv_dtype: str) -> int:
    """Bytes per pool element of a quantized pool (1), 4 otherwise."""
    return 1 if kv_dtype in QMAX else 4


def kv_dtype_of(dtype: torch.dtype) -> str:
    """The ``kv_dtype`` a pool of ``dtype`` holds: int8 and float8_e4m3fn
    are codes, any wider dtype is the unquantized "fp32" scheme."""
    if dtype == torch.int8:
        return "int8"
    if dtype == torch.float8_e4m3fn:
        return "fp8"
    return "fp32"


def scale_nbytes(num_kv_heads: int, num_pages: int, kv_dtype: str) -> int:
    """Bytes of one scale table (0 for "fp32"): one float32 per (kv head,
    physical page)."""
    if kv_dtype not in QMAX:
        return 0
    return 4 * num_kv_heads * num_pages


def scale_pair(k_scale_tab, v_scale_tab) -> bool:
    """Whether a K/V pool pair is quantized; one-sided scale tables would
    attend over raw codes, so they raise."""
    if (k_scale_tab is None) != (v_scale_tab is None):
        raise ValueError("k_scales and v_scales must be passed together")
    return k_scale_tab is not None


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def index_pages(pages: torch.Tensor, index) -> torch.Tensor:
    """``pages[index]`` for a pool of any dtype, float8 included."""
    out = _bytes(pages)[index]
    return out.view(pages.dtype) if pages.dtype == torch.float8_e4m3fn else out


def put_pages(pages: torch.Tensor, index, values: torch.Tensor) -> None:
    """``pages[index] = values`` in place, for a pool of any dtype;
    ``values`` already has the pool's dtype."""
    _bytes(pages)[index] = _bytes(values)


def _safe(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s > 0.0, s, torch.ones_like(s))


def _encode(x: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """float32 at unit scale (the caller has divided) -> codes."""
    if kv_dtype == "int8":
        return torch.clamp(torch.round(x), -127.0, 127.0).to(torch.int8)
    return x.to(storage_dtype(kv_dtype))


def quantize_pages(pages: torch.Tensor, kv_dtype: str):
    """Quantize ``(..., page_size, D)`` page content to ``(codes, scales)``
    with one scale per leading index, ``(Hkv, P)`` for a pool. "fp32"
    returns ``(pages as float32, None)``."""
    validate_kv_dtype(kv_dtype)
    x = pages.float()
    if kv_dtype == "fp32":
        return x, None
    amax = x.abs().amax(dim=(-2, -1))
    scales = amax / QMAX[kv_dtype]
    codes = _encode(x / _safe(scales)[..., None, None], kv_dtype)
    return codes, scales.float()


def dequantize_pages(codes: torch.Tensor, scales) -> torch.Tensor:
    """Inverse of :func:`quantize_pages`: codes ``(..., ps, D)`` times
    scales ``(...)`` -> float32; ``scales=None`` is the identity."""
    x = codes.float()
    if scales is None:
        return x
    return x * scales.float()[..., None, None]


def append_rows(pages, scales, rows, pids, offs, kv_dtype: str):
    """Write one new token row per sequence into its page, rescaling each
    touched page whose range the new row widens, in place.

    ``pages`` (Hkv, P, ps, D) codes; ``scales`` (Hkv, P) float32; ``rows``
    (Hkv, B, D) new K (or V) rows; ``pids`` / ``offs`` (B,) physical page
    and in-page offset per sequence (a live row owns its tail page, so the
    pages are distinct across live rows; rows frozen on the null page all
    write there, a sink). Returns ``(pages, scales)``. "fp32" is the plain
    row store with ``scales`` passed through.

    The rescale is where a quantized page loses information beyond the
    format: existing codes shrink by ``old_scale / new_scale`` (<= 1) when a
    louder token arrives.
    """
    validate_kv_dtype(kv_dtype)
    rows = rows.float()
    pids = pids.long()
    offs = offs.long()
    if kv_dtype == "fp32":
        pages[:, pids, offs] = rows.to(pages.dtype)
        return pages, scales
    qmax = QMAX[kv_dtype]
    old_s = scales[:, pids]                                    # (Hkv, B)
    new_s = torch.maximum(old_s, rows.abs().amax(dim=-1) / qmax)
    touched = index_pages(pages, (slice(None), pids)).float()  # (Hkv, B, ps, D)
    rescaled = _encode(touched * (old_s / _safe(new_s))[..., None, None], kv_dtype)
    new_codes = _encode(rows / _safe(new_s)[..., None], kv_dtype)
    put_pages(rescaled, (slice(None), torch.arange(pids.shape[0], device=pids.device), offs),
              new_codes)
    put_pages(pages, (slice(None), pids), rescaled)
    scales[:, pids] = new_s
    return pages, scales


def scatter_pages(pages, scales, new, pids, kv_dtype: str):
    """Write whole freshly computed pages into the pool, in place (the
    prefill's tail scatter): ``new`` (Hkv, n, ps, D) page-shaped content,
    ``pids`` the (n,) destination physical ids. Quantized pools store codes
    and set the destinations' scale entries; "fp32" is the plain store
    with ``scales`` passed through. Destinations are freshly allocated (or
    the null page, a sink), so per-page amax quantization is exact."""
    validate_kv_dtype(kv_dtype)
    pids = pids.long()
    if kv_dtype == "fp32":
        pages[:, pids] = new.to(pages.dtype)
        return pages, scales
    codes, s = quantize_pages(new, kv_dtype)
    put_pages(pages, (slice(None), pids), codes)
    scales[:, pids] = s
    return pages, scales


def cow_scales(scales, src, dst):
    """Copy-on-write of the scale entry, in place: ``dst`` dequantizes as
    ``src`` does. ``None`` (an unquantized pool) passes through."""
    if scales is None:
        return scales
    scales[..., dst] = scales[..., src]
    return scales
