"""The model stack: embedding, attention + MLP layers, final norm, LM head.

Port of the ``kind="attn", ffn="mlp"`` stack of ``repro.models.transformer``
(the llama family): ``forward`` (training), ``prefill`` and ``decode_step``.
A Python loop over layers takes the place of the JAX package's scan over
periods. Parameters are a dict::

    {"embed": (V, D), "ln_f": (D,), "head": (D, V),
     "layers": [{"ln1", "wq", "wk", "wv", "wo", "ln2",
                 "w_gate", "w_up", "w_down"}, ...]}

Matmul weights and the embedding table are stored in ``param_dtype``: by
default the compute dtype, which serving uses (the JAX package keeps
float32 parameters and casts each to the compute dtype before its product,
so the results are the same); training passes ``torch.float32``, the JAX
package's parameter dtype, so AdamW updates float32 masters. Norm gains and
the LM head stay float32, as the JAX head runs in float32.

``init_model`` draws weights from a ``torch.Generator`` with the JAX
package's distributions; ``from_jax_params`` carries a JAX parameter tree
(as numpy) across so both packages compute the same function.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import device as device_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers

Params = Dict[str, Any]

_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.layer_specs():
        if spec.kind != "attn" or spec.ffn != "mlp" or spec.cross_attn:
            raise NotImplementedError(
                f"layer kind={spec.kind!r} ffn={spec.ffn!r} cross_attn="
                f"{spec.cross_attn} is not ported yet (ROADMAP Queue A, other "
                "model families)")
    if cfg.qk_norm or cfg.num_codebooks != 1 or cfg.tie_embeddings:
        raise NotImplementedError(
            "qk-norm, multi-codebook and tied-embedding models are not "
            "ported yet (ROADMAP Queue A, other model families)")


def _param_dtype(cfg: ModelConfig, param_dtype) -> torch.dtype:
    return device_lib.dtype_of(cfg.compute_dtype) if param_dtype is None else param_dtype


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               param_dtype: Optional[torch.dtype] = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the distributions of ``repro.models.transformer.init_model``: normal
    weights scaled by 1/sqrt(fan_in), embedding by d_model^-0.5, zero norm
    gains (the ``(1 + scale)`` identity). Matmul weights and the embedding
    are ``param_dtype`` (default: the compute dtype)."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dt = _param_dtype(cfg, param_dtype)
    d, h, hkv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def normal(shape, scale, dtype=dt):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * scale).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    params: Params = {"embed": normal((cfg.vocab, d), d**-0.5)}
    params["layers"] = [
        {
            "ln1": zeros(d),
            "wq": normal((d, h * hd), 1 / math.sqrt(d)),
            "wk": normal((d, hkv * hd), 1 / math.sqrt(d)),
            "wv": normal((d, hkv * hd), 1 / math.sqrt(d)),
            "wo": normal((h * hd, d), 1 / math.sqrt(h * hd)),
            "ln2": zeros(d),
            "w_gate": normal((d, f), 1 / math.sqrt(d)),
            "w_up": normal((d, f), 1 / math.sqrt(d)),
            "w_down": normal((f, d), 1 / math.sqrt(f)),
        }
        for _ in range(cfg.n_layers)
    ]
    params["ln_f"] = zeros(d)
    params["head"] = normal((d, cfg.vocab), 1 / math.sqrt(d), torch.float32)
    return params


def from_jax_params(tree, cfg: ModelConfig, *, device=None,
                    param_dtype: Optional[torch.dtype] = None) -> Params:
    """Convert a ``repro.models.transformer.init_model`` tree whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, params)``) into this
    package's parameter dict on ``device``, matmul weights and embedding in
    ``param_dtype`` (default: the compute dtype)."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    dt = _param_dtype(cfg, param_dtype)

    def t(a, dtype=dt):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    per_layer: List[dict] = []
    n_pattern = len(cfg.layer_pattern)
    stacks, rem = tree["layers"], tree["layers_rem"]
    n_periods = cfg.n_layers // n_pattern
    for p in range(n_periods):
        for j in range(n_pattern):
            per_layer.append(_jax_layer(stacks[j], p))
    for r in rem:
        per_layer.append(_jax_layer(r, None))
    layers_out = []
    for lp in per_layer:
        out = {k: t(v) for k, v in lp.items() if k in _MATMUL_KEYS}
        out["ln1"] = t(lp["ln1"], torch.float32)
        out["ln2"] = t(lp["ln2"], torch.float32)
        layers_out.append(out)
    return {
        "embed": t(tree["embed"]["table_vd"]),
        "layers": layers_out,
        "ln_f": t(tree["ln_f"]["scale_r"], torch.float32),
        "head": t(tree["head"]["w_dm"], torch.float32),
    }


def _jax_layer(tree, period: Optional[int]) -> dict:
    pick = (lambda a: np.asarray(a)[period]) if period is not None else np.asarray
    a, m = tree["attn"], tree["mlp"]
    return {
        "ln1": pick(tree["ln1"]["scale_r"]), "ln2": pick(tree["ln2"]["scale_r"]),
        "wq": pick(a["wq_dm"]), "wk": pick(a["wk_dm"]), "wv": pick(a["wv_dm"]),
        "wo": pick(a["wo_md"]), "w_gate": pick(m["wi_gate_dm"]),
        "w_up": pick(m["wi_up_dm"]), "w_down": pick(m["wo_md"]),
    }


def _embed_tokens(params, cfg: ModelConfig, tokens):
    return layers.embed(params["embed"], tokens, scale_by_dim=cfg.embed_scale,
                        compute_dtype=device_lib.dtype_of(cfg.compute_dtype))


def _logits(params, cfg: ModelConfig, x):
    logits = x.float() @ params["head"]
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _mlp(lp, x):
    return layers.mlp(lp["w_gate"], lp["w_up"], lp["w_down"], layers.rmsnorm(lp["ln2"], x))


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    """The JAX stack's aux losses; all zero for the llama family (no MoE)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_lb_loss": z, "moe_z_loss": z, "moe_dropped_frac": z}


def _train_layer(lp, x, cfg: ModelConfig, spec):
    x = x + attn_lib.attention_block(lp, layers.rmsnorm(lp["ln1"], x), cfg, spec)
    return x + _mlp(lp, x)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward: tokens (B, S) -> (logits (B, S, V) float32, aux).

    With ``remat`` each layer runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward pass, as the JAX package's ``jax.checkpoint``
    recomputes each period: only the layer inputs stay alive, and the
    attention forward (K1) runs twice per layer."""
    x = _embed_tokens(params, cfg, tokens)
    for spec, lp in zip(cfg.layer_specs(), params["layers"]):
        if remat:
            x = checkpoint(_train_layer, lp, x, cfg, spec, use_reentrant=False)
        else:
            x = _train_layer(lp, x, cfg, spec)
    x = layers.rmsnorm(params["ln_f"], x)
    return _logits(params, cfg, x), _zero_aux(x.device)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_len: int, last_positions: Optional[torch.Tensor] = None,
            prefix_caches: Optional[List[dict]] = None,
            page_table: Optional[torch.Tensor] = None,
            prefix_len: Optional[torch.Tensor] = None,
            plan=None) -> Tuple[torch.Tensor, List[dict]]:
    """Prefill: returns (logits at the last real position (B, V) float32,
    per-layer caches ``{"k", "v"}`` of shape (B, Hkv, cache_len, hd)).

    ``prefix_caches`` (the per-layer page pools) + ``page_table`` (B, pages)
    + ``prefix_len`` (B,): prefix-extension prefill — ``tokens`` holds only
    the tail, which attends to the prefix in place in its pages; the
    returned caches cover the tail only. ``plan`` is the caller-resolved
    extend plan (None lets each layer resolve its own).
    """
    x = _embed_tokens(params, cfg, tokens)
    b, s = tokens.shape
    positions = tail_len = None
    if prefix_caches is not None:
        if page_table is None or prefix_len is None:
            raise ValueError("prefix-extension prefill needs page_table and prefix_len")
        positions = prefix_len.long()[:, None] + torch.arange(s, device=x.device)[None, :]
        tail_len = (last_positions + 1 if last_positions is not None
                    else torch.full((b,), s, device=x.device)).to(torch.int32)
    caches = []
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs(), params["layers"])):
        h = layers.rmsnorm(lp["ln1"], x)
        if prefix_caches is not None:
            y, c = attn_lib.attention_prefill_paged(
                lp, h, cfg, spec, prefix_caches[i], page_table, prefix_len,
                tail_len, cache_len=cache_len, positions=positions, plan=plan)
        else:
            y, c = attn_lib.attention_prefill(lp, h, cfg, spec, cache_len=cache_len,
                                              positions=positions)
        caches.append(c)
        x = x + y
        x = x + _mlp(lp, x)
    if last_positions is None:
        x = x[:, -1:]
    else:
        x = torch.gather(x, 1, last_positions.long()[:, None, None].expand(b, 1, x.shape[-1]))
    x = layers.rmsnorm(params["ln_f"], x)
    return _logits(params, cfg, x)[:, 0], caches


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                caches: List[dict], lengths: torch.Tensor, *,
                page_table: torch.Tensor) -> Tuple[torch.Tensor, List[dict]]:
    """One decode step over the paged pools: returns (logits (B, V), caches).

    ``token`` (B,); ``lengths`` (B,) int32 including the new token;
    ``page_table`` (B, max_pages) int32. The pools are updated in place."""
    x = _embed_tokens(params, cfg, token[:, None])
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs(), params["layers"])):
        h = layers.rmsnorm(lp["ln1"], x)
        y, _ = attn_lib.attention_decode_paged(lp, h, cfg, spec, caches[i],
                                               page_table, lengths)
        x = x + y
        x = x + _mlp(lp, x)
    x = layers.rmsnorm(params["ln_f"], x)
    return _logits(params, cfg, x)[:, 0], caches


def init_paged_caches(cfg: ModelConfig, num_pages: int, page_size: int,
                      device) -> List[dict]:
    """One zero-filled head-major page pool per attention layer, all indexed
    by the same physical page ids (one allocator drives every layer)."""
    _check_supported(cfg)
    dt = device_lib.dtype_of(cfg.compute_dtype)
    return [attn_lib.init_paged_cache(cfg, num_pages, page_size, dt, device)
            for _ in range(cfg.n_layers)]
