"""GQA self- and cross-attention blocks of the serving paths and of training.

Port of ``repro.models.attention``: ``_project_qkv``, ``attention_block``
(training), ``attention_prefill``, ``attention_prefill_paged``,
``attention_decode`` (dense stripes), ``attention_decode_paged``,
``init_cache`` and ``init_paged_cache``, with quantized page pools (int8 /
fp8 codes and per-(kv head, page) scales, ``cache.quant``). A cross layer
(``spec.cross_attn``, llama-3.2-vision) passes ``encoder_states``: its K/V
are projected from them, without rotary, and attended without causality
or window; its decode (``is_cross``) reads that K/V as a read-only stripe,
every row live. Without ``encoder_states`` a cross layer's weights run as
causal, roped self-attention, as in the JAX package. Layer weights are a
dict ``{"wq", "wk", "wv", "wo"}`` laid out ``(d_in, d_out)`` as in the JAX
package, in any dtype: each is cast to the activations' dtype at its
product; a qk-norm model (gemma3) adds float32 ``"q_norm"`` / ``"k_norm"``
gains of width ``head_dim``. The page pools and the dense stripes are
updated in place (JAX returns new arrays); the functions still return the
cache dict so call sites read the same in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.cache import quant
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import plan as plan_lib
from repro_torch.models import layers


def _plan(cfg: ModelConfig, shape, x: torch.Tensor, **kw) -> plan_lib.AttentionPlan:
    return plan_lib.plan_for_config(cfg, shape, device_type=x.device.type,
                                    dtype_bytes=x.element_size(), **kw)


def _project_qkv(p, x, cfg: ModelConfig, positions, rope_theta, kv_x=None,
                 rope: bool = True):
    """x: (B, S, D) -> q (B, H, S, hd), k / v (B, Hkv, Skv, hd), K/V from
    ``kv_x`` (B, Skv, D) where given (cross-attention), else from x. Under
    qk-norm q and k are RMS-normed over ``hd`` (``(1 + scale)`` gains)
    before rotary, as the JAX package does, on every path; ``rope=False``
    (cross-attention) leaves both unrotated."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    skv = src.shape[1]
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd).transpose(1, 2)
    k = (src @ p["wk"].to(x.dtype)).reshape(b, skv, hkv, hd).transpose(1, 2)
    v = (src @ p["wv"].to(x.dtype)).reshape(b, skv, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = layers.rmsnorm(p["q_norm"], q)
        k = layers.rmsnorm(p["k_norm"], k)
    if rope:
        q = layers.apply_rotary(q, positions, rope_theta)
        k = layers.apply_rotary(k, positions, rope_theta)
    return q, k, v


def _full_attention(p, x, cfg: ModelConfig, spec: LayerSpec, positions, encoder_states):
    """q, k, v and the attention output (B, H, S, hd) of a whole sequence:
    causal, roped and windowed self-attention, or, on a cross layer given
    ``encoder_states`` (B, Skv, D), non-causal attention over their K/V
    with neither rotary nor window."""
    b, s, _ = x.shape
    cross = spec.cross_attn and encoder_states is not None
    if positions is None and not cross:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, spec.rope_theta,
                           kv_x=encoder_states if cross else None, rope=not cross)
    window = None if cross else spec.window
    plan = _plan(cfg, (b, cfg.n_heads, cfg.n_kv_heads, s, k.shape[2], cfg.head_dim), x,
                 phase=plan_lib.PREFILL, window=window)
    o = ops.flash_attention(q, k, v, causal=not cross, window=window,
                            softcap=cfg.attn_softcap, plan=plan)
    return q, k, v, o


def _out(p, o, cfg: ModelConfig):
    b, _, s, _ = o.shape
    return o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"].to(o.dtype)


def attention_block(p, x, cfg: ModelConfig, spec: LayerSpec, *,
                    positions=None, encoder_states=None) -> torch.Tensor:
    """Full-sequence attention (training). x (B, S, D): causal
    self-attention, or cross-attention over ``encoder_states`` (B, Skv, D)
    on a cross layer (``_full_attention``).

    Differentiable: ``ops.flash_attention`` runs K1 forward and K5 / K6
    backward on the card."""
    return _out(p, _full_attention(p, x, cfg, spec, positions, encoder_states)[3], cfg)


def attention_prefill(p, x, cfg: ModelConfig, spec: LayerSpec, *, cache_len: int,
                      positions=None, encoder_states=None) -> Tuple[torch.Tensor, dict]:
    """Full-prompt attention as ``attention_block``; also returns the K/V,
    padded to ``cache_len``, for the caller to store: the prompt's, or on a
    cross layer the encoder states' (the JAX package passes their length,
    so the cross cache holds them unpadded)."""
    _, k, v, o = _full_attention(p, x, cfg, spec, positions, encoder_states)
    pad = cache_len - k.shape[2]
    # Contiguous stripes, as the dense decode kernels read them (with no
    # padding, F.pad keeps the projection's strides).
    cache = {"k": F.pad(k, (0, 0, 0, pad)).contiguous(),
             "v": F.pad(v, (0, 0, 0, pad)).contiguous()}
    return _out(p, o, cfg), cache


def attention_prefill_paged(p, x, cfg: ModelConfig, spec: LayerSpec, cache: dict,
                            page_table, prefix_len, tail_len, *, cache_len: int,
                            positions, plan: Optional[plan_lib.AttentionPlan] = None
                            ) -> Tuple[torch.Tensor, dict]:
    """Prefix-extension prefill: the first ``prefix_len[b]`` positions are
    already in the pool; the tail attends to them in place through
    ``page_table`` (the K2 kernel, no gather; a quantized pool's scales ride
    along), or by the gather route where the plan's impl says so. Returns
    the tail's K/V padded to ``cache_len``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, spec.rope_theta)
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    if plan is None:
        plan = _plan(cfg, (b, cfg.n_heads, cfg.n_kv_heads, s,
                           page_table.shape[1] * k_pages.shape[2] + s, cfg.head_dim),
                     x, phase=plan_lib.EXTEND, kv_layout=plan_lib.PAGED,
                     page_size=k_pages.shape[2], window=spec.window)
    o = ops.paged_prefill_attention(
        q, k_pages, v_pages, page_table, k, v, prefix_len, tail_len,
        softcap=cfg.attn_softcap, window=spec.window, plan=plan,
        k_scales=cache.get("k_scales"), v_scales=cache.get("v_scales"))
    pad = cache_len - s
    cache_out = {"k": F.pad(k, (0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, pad))}
    return _out(p, o, cfg), cache_out


def attention_decode(p, x, cfg: ModelConfig, spec: LayerSpec, cache: dict,
                     lengths, *, is_cross: bool = False) -> Tuple[torch.Tensor, dict]:
    """One-token decode over dense stripes. x (B, 1, D); cache k / v
    (B, Hkv, Smax, hd), possibly a view cut to the live width; lengths (B,)
    int32 *including* the new token. The new K/V row is written in place at
    ``lengths - 1`` (a length-0 row writes position 0 of its free slot, as
    the JAX package's clamped update does), then the dense decode kernel
    reads the stripes.

    ``is_cross``: the cache holds a cross layer's encoder K/V, read-only.
    Only q is projected (qk-normed, not rotated); every row attends all
    ``Smax`` positions, whatever ``lengths`` says."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k, v = cache["k"], cache["v"]
    if is_cross:
        q = (x @ p["wq"].to(x.dtype)).reshape(b, 1, h, hd).transpose(1, 2)
        if cfg.qk_norm:
            q = layers.rmsnorm(p["q_norm"], q)
        kv_len = torch.full((b,), k.shape[2], dtype=torch.int32, device=x.device)
        plan = _plan(cfg, (b, h, hkv, 1, k.shape[2], hd), x, phase=plan_lib.DECODE,
                     kv_layout=plan_lib.DENSE)
        o = ops.decode_attention(q[:, :, 0].contiguous(), k, v, kv_len,
                                 softcap=cfg.attn_softcap, plan=plan)
        return o.reshape(b, 1, h * hd) @ p["wo"].to(o.dtype), cache
    positions = (lengths.long() - 1)[:, None]
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, spec.rope_theta)
    rows = torch.arange(b, device=x.device)
    idx = torch.clamp(lengths.long() - 1, min=0)
    k[rows, :, idx] = k_new[:, :, 0].to(k.dtype)
    v[rows, :, idx] = v_new[:, :, 0].to(v.dtype)
    plan = _plan(cfg, (b, h, hkv, 1, k.shape[2], hd), x, phase=plan_lib.DECODE,
                 kv_layout=plan_lib.DENSE, window=spec.window)
    o = ops.decode_attention(q[:, :, 0].contiguous(), k, v, lengths,
                             softcap=cfg.attn_softcap, window=spec.window, plan=plan)
    return o.reshape(b, 1, h * hd) @ p["wo"].to(o.dtype), cache


def attention_decode_paged(p, x, cfg: ModelConfig, spec: LayerSpec, cache: dict,
                           page_table, lengths) -> Tuple[torch.Tensor, dict]:
    """One-token decode over the paged pool. x (B, 1, D); lengths (B,) int32
    *including* the new token. The new K/V row is written in place into the
    sequence's tail page (a quantized pool through
    ``quant.append_rows``, rescaling the page when the row widens its
    range, so the new token's own K is quantized before it is read), then
    the paged decode kernel reads the pool through the page table."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    ps = k_pages.shape[2]
    positions = (lengths.long() - 1)[:, None]
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, spec.rope_theta)
    idx = torch.clamp(lengths.long() - 1, min=0)
    pids = torch.gather(page_table.long(), 1, (idx // ps)[:, None])[:, 0]
    offs = idx % ps
    kv_dtype = quant.kv_dtype_of(k_pages.dtype)
    k_scale_tab, v_scale_tab = cache.get("k_scales"), cache.get("v_scales")
    quant.append_rows(k_pages, k_scale_tab, k_new[:, :, 0].transpose(0, 1), pids, offs,
                      kv_dtype)
    quant.append_rows(v_pages, v_scale_tab, v_new[:, :, 0].transpose(0, 1), pids, offs,
                      kv_dtype)
    plan = _plan(cfg, (b, h, hkv, 1, page_table.shape[1] * ps, hd), x,
                 phase=plan_lib.DECODE, kv_layout=plan_lib.PAGED, page_size=ps,
                 window=spec.window, kv_dtype=kv_dtype)
    o = ops.paged_decode_attention(q[:, :, 0].contiguous(), k_pages, v_pages,
                                   page_table, lengths, softcap=cfg.attn_softcap,
                                   window=spec.window, plan=plan, k_scales=k_scale_tab,
                                   v_scales=v_scale_tab)
    return o.reshape(b, 1, h * hd) @ p["wo"].to(o.dtype), cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device) -> dict:
    """Dense per-slot stripes of one layer, zero-filled:
    ``(batch, Hkv, cache_len, head_dim)`` for K and for V."""
    shape = (batch, cfg.n_kv_heads, cache_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, dtype,
                     device, kv_dtype: str = "fp32") -> dict:
    """Head-major page pool of one layer, zero-filled:
    ``(Hkv, num_pages, page_size, head_dim)`` for K and for V, in ``dtype``.
    A quantized ``kv_dtype`` ("int8", "fp8") stores 1-byte codes instead,
    plus zeroed ``(Hkv, num_pages)`` float32 ``k_scales`` / ``v_scales``,
    one per (kv head, physical page), as the JAX package does."""
    quant.validate_kv_dtype(kv_dtype)
    shape = (cfg.n_kv_heads, num_pages, page_size, cfg.head_dim)
    if kv_dtype == "fp32":
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    codes = quant.storage_dtype(kv_dtype)
    return {"k_pages": torch.zeros(shape, dtype=codes, device=device),
            "v_pages": torch.zeros(shape, dtype=codes, device=device),
            "k_scales": torch.zeros(shape[:2], dtype=torch.float32, device=device),
            "v_scales": torch.zeros(shape[:2], dtype=torch.float32, device=device)}
