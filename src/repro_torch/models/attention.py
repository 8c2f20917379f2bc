"""GQA self-attention blocks of the paged serving path and of training.

Port of the self-attention subset of ``repro.models.attention``:
``_project_qkv``, ``attention_block`` (training), ``attention_prefill``,
``attention_prefill_paged``, ``attention_decode_paged`` and
``init_paged_cache``. Layer weights are a dict ``{"wq", "wk", "wv", "wo"}``
laid out ``(d_in, d_out)`` as in the JAX package, in any dtype: each is
cast to the activations' dtype at its product. The page pools are updated
in place (JAX returns new arrays); the functions still return the cache
dict so call sites read the same in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import plan as plan_lib
from repro_torch.models import layers


def _plan(cfg: ModelConfig, shape, x: torch.Tensor, **kw) -> plan_lib.AttentionPlan:
    return plan_lib.plan_for_config(cfg, shape, device_type=x.device.type,
                                    dtype_bytes=x.element_size(), **kw)


def _project_qkv(p, x, cfg: ModelConfig, positions, rope_theta):
    """x: (B, S, D) -> q (B, H, S, hd), k / v (B, Hkv, S, hd)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd).transpose(1, 2)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, hkv, hd).transpose(1, 2)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, hkv, hd).transpose(1, 2)
    q = layers.apply_rotary(q, positions, rope_theta)
    k = layers.apply_rotary(k, positions, rope_theta)
    return q, k, v


def _out(p, o, cfg: ModelConfig):
    b, _, s, _ = o.shape
    return o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"].to(o.dtype)


def attention_block(p, x, cfg: ModelConfig, spec: LayerSpec, *,
                    positions=None) -> torch.Tensor:
    """Full-sequence causal self-attention (training). x (B, S, D).

    Differentiable: ``ops.flash_attention`` runs K1 forward and K5 / K6
    backward on the card."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, spec.rope_theta)
    plan = _plan(cfg, (b, cfg.n_heads, cfg.n_kv_heads, s, s, cfg.head_dim), x,
                 phase=plan_lib.PREFILL, window=spec.window)
    o = ops.flash_attention(q, k, v, causal=True, window=spec.window,
                            softcap=cfg.attn_softcap, plan=plan)
    return _out(p, o, cfg)


def attention_prefill(p, x, cfg: ModelConfig, spec: LayerSpec, *, cache_len: int,
                      positions=None) -> Tuple[torch.Tensor, dict]:
    """Full-prompt causal self-attention; also returns the prompt's K/V,
    padded to ``cache_len``, for the caller to store."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, spec.rope_theta)
    plan = _plan(cfg, (b, cfg.n_heads, cfg.n_kv_heads, s, s, cfg.head_dim), x,
                 phase=plan_lib.PREFILL, window=spec.window)
    o = ops.flash_attention(q, k, v, causal=True, window=spec.window,
                            softcap=cfg.attn_softcap, plan=plan)
    pad = cache_len - s
    cache = {"k": F.pad(k, (0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, pad))}
    return _out(p, o, cfg), cache


def attention_prefill_paged(p, x, cfg: ModelConfig, spec: LayerSpec, cache: dict,
                            page_table, prefix_len, tail_len, *, cache_len: int,
                            positions, plan: Optional[plan_lib.AttentionPlan] = None
                            ) -> Tuple[torch.Tensor, dict]:
    """Prefix-extension prefill: the first ``prefix_len[b]`` positions are
    already in the pool; the tail attends to them in place through
    ``page_table`` (the K2 kernel, no gather). Returns the tail's K/V padded
    to ``cache_len``."""
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
        softcap=cfg.attn_softcap, window=spec.window, plan=plan)
    pad = cache_len - s
    cache_out = {"k": F.pad(k, (0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, pad))}
    return _out(p, o, cfg), cache_out


def attention_decode_paged(p, x, cfg: ModelConfig, spec: LayerSpec, cache: dict,
                           page_table, lengths) -> Tuple[torch.Tensor, dict]:
    """One-token decode over the paged pool. x (B, 1, D); lengths (B,) int32
    *including* the new token. The new K/V row is written in place into the
    sequence's tail page, then the paged decode kernel reads the pool
    through the page table."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    ps = k_pages.shape[2]
    positions = (lengths.long() - 1)[:, None]
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, spec.rope_theta)
    idx = torch.clamp(lengths.long() - 1, min=0)
    pids = torch.gather(page_table.long(), 1, (idx // ps)[:, None])[:, 0]
    offs = idx % ps
    k_pages[:, pids, offs] = k_new[:, :, 0].transpose(0, 1).to(k_pages.dtype)
    v_pages[:, pids, offs] = v_new[:, :, 0].transpose(0, 1).to(v_pages.dtype)
    plan = _plan(cfg, (b, h, hkv, 1, page_table.shape[1] * ps, hd), x,
                 phase=plan_lib.DECODE, kv_layout=plan_lib.PAGED, page_size=ps,
                 window=spec.window)
    o = ops.paged_decode_attention(q[:, :, 0].contiguous(), k_pages, v_pages,
                                   page_table, lengths, softcap=cfg.attn_softcap,
                                   window=spec.window, plan=plan)
    return o.reshape(b, 1, h * hd) @ p["wo"].to(o.dtype), cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, dtype,
                     device) -> dict:
    """Head-major page pool of one layer, zero-filled:
    ``(Hkv, num_pages, page_size, head_dim)`` for K and for V."""
    shape = (cfg.n_kv_heads, num_pages, page_size, cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
