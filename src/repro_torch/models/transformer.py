"""The model stack: embedding, attention / Mamba-2 / hybrid layers, MLP or
MoE FFN, final norm, LM head.

Port of ``repro.models.transformer`` for the ``attn``, ``mamba`` and
``hybrid`` layer kinds with ``ffn="mlp"``, ``"moe"`` or ``"none"`` (llama,
mamba2, hymba, gemma, moonshot, mixtral), for gated cross-attention
layers (llama-3.2-vision) and for multi-codebook token streams (musicgen):
``forward`` (training, with the MoE aux losses
summed over the stack), ``prefill`` and ``decode_step`` over paged pools
or dense stripes (cross layers: dense only, as in the JAX package). A
Python loop over layers takes the place of the JAX package's scan over
periods. Parameters are a dict::

    {"embed": (V, D), or (K, V, D) for K > 1 codebooks,
     "ln_f": (D,), "head": (D, V) unless tied,
     "vision_proj": (vision_dim, D)                   (vision models),
     "layers": [{"ln1",
                 "wq", "wk", "wv", "wo"              (attn, hybrid),
                 "q_norm", "k_norm"                   (qk-norm models: gemma3),
                 "mamba": {...}                       (mamba, hybrid; models/ssm.py),
                 "ln_attn_out", "ln_mamba_out"        (hybrid),
                 "ln_cross", "cross": {"wq", "wk", "wv", "wo"}, "cross_gate" ()
                                                      (cross layers),
                 "ln2", "w_gate", "w_up", "w_down"    (ffn "mlp"),
                 "ln2", "moe": {...}                  (ffn "moe"; models/moe.py)}, ...]}

A cross layer adds ``tanh(cross_gate) * cross_attn(rmsnorm(ln_cross, x))``
after its token mixer and before its FFN; the cross block's K/V come from
the image embeddings through ``vision_proj`` (the vision tower is a stub,
as in the JAX config). Its gate starts at zero, so a fresh model ignores
the images until it is trained. ``prefill`` returns each cross layer's K/V
under ``"cross"`` in its cache dict, and ``decode_step`` reads them.

Matmul weights are stored in ``param_dtype``: by default the compute
dtype, which serving uses (the JAX package keeps float32 parameters and
casts each to the compute dtype before its product, so the results are the
same); training passes ``torch.float32``, the JAX package's parameter
dtype, so AdamW updates float32 masters. Norm gains and the LM head stay
float32, as the JAX head runs in float32; a tied embedding is kept in
float32 for the same reason, since it is the head too.

A model of ``num_codebooks`` K > 1 (musicgen) takes (B, S, K) tokens:
each position's embedding is the sum of its K codebooks' rows of the
(K, V, D) table, summed in float32 in codebook order; the same table gives
(B, S, K, V) float32 logits, K tied heads, as in the JAX package.

A hybrid layer (hymba) runs attention and a Mamba-2 block side by side on
the same normed input and adds ``0.5 * (rmsnorm(ya) + rmsnorm(ym))``. The
prefill's SSM cache is exact under right padding (``ssm.mamba_block`` with
``last_positions``): the JAX package's ``_mamba_with_cache`` takes the
state and the conv history from the padded sequence, so pad tokens leak
into the recurrent state there (ROADMAP Queue C). Likewise an MoE FFN
gives no expert slot to a prefill's pad tokens or to a decode tick's
frozen rows (``moe.moe_ffn(valid=...)``), where the JAX package lets them
push real tokens out of an expert.

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

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core import device as device_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

Params = Dict[str, Any]

_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: Mamba-2 weights stored in the parameter dtype (the rest stay float32).
_SSM_CAST_KEYS = ("win", "conv_w", "conv_b", "wout")
#: The JAX package's names of an MoE layer's leaves, by the port's.
_MOE_KEYS = {"router": "router_de", "w_gate": "wi_gate_edm", "w_up": "wi_up_edm",
             "w_down": "wo_emd"}
_ATTN_KINDS = ("attn", "hybrid")
_SSM_KINDS = ("mamba", "hybrid")


def _check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.layer_specs():
        if spec.kind not in ("attn", "mamba", "hybrid") or spec.ffn not in ("mlp", "moe", "none"):
            raise NotImplementedError(
                f"layer kind={spec.kind!r} ffn={spec.ffn!r}: the model stack has attn, "
                "mamba and hybrid layers with an mlp, moe or no FFN, as the JAX package")
        if spec.kind in _SSM_KINDS and cfg.ssm is None:
            raise ValueError(f"layer kind={spec.kind!r} needs cfg.ssm")
        if spec.ffn == "moe" and cfg.moe is None:
            raise ValueError('ffn="moe" needs cfg.moe')


def _param_dtype(cfg: ModelConfig, param_dtype) -> torch.dtype:
    return device_lib.dtype_of(cfg.compute_dtype) if param_dtype is None else param_dtype


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               param_dtype: Optional[torch.dtype] = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the distributions of ``repro.models.transformer.init_model``: normal
    weights scaled by 1/sqrt(fan_in), embedding by d_model^-0.5, zero norm
    gains (the ``(1 + scale)`` identity), ``ssm.init_mamba`` for Mamba-2
    blocks, ``moe.init_moe`` for MoE FFNs, zero cross gates. Matmul
    weights, ``vision_proj`` and an untied embedding are ``param_dtype``
    (default: the compute dtype); a multi-codebook model's (K, V, D) table
    is float32, as it is the heads too."""
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

    def attention() -> dict:
        p = dict(wq=normal((d, h * hd), 1 / math.sqrt(d)),
                 wk=normal((d, hkv * hd), 1 / math.sqrt(d)),
                 wv=normal((d, hkv * hd), 1 / math.sqrt(d)),
                 wo=normal((h * hd, d), 1 / math.sqrt(h * hd)))
        if cfg.qk_norm:
            p.update(q_norm=zeros(hd), k_norm=zeros(hd))
        return p

    def layer(spec: LayerSpec) -> dict:
        lp = {"ln1": zeros(d)}
        if spec.kind in _ATTN_KINDS:
            lp.update(attention())
        if spec.kind in _SSM_KINDS:
            lp["mamba"] = ssm_lib.init_mamba(gen, d, cfg.ssm, dtype=dt, device=dev)
        if spec.kind == "hybrid":
            lp.update(ln_attn_out=zeros(d), ln_mamba_out=zeros(d))
        if spec.cross_attn:
            lp.update(ln_cross=zeros(d), cross=attention(),
                      cross_gate=torch.zeros((), dtype=torch.float32, device=dev))
        if spec.ffn == "mlp":
            lp.update(ln2=zeros(d), w_gate=normal((d, f), 1 / math.sqrt(d)),
                      w_up=normal((d, f), 1 / math.sqrt(d)),
                      w_down=normal((f, d), 1 / math.sqrt(f)))
        elif spec.ffn == "moe":
            lp.update(ln2=zeros(d), moe=moe_lib.init_moe(gen, d, cfg.moe, dtype=dt, device=dev))
        return lp

    if cfg.num_codebooks > 1:
        params: Params = {"embed": normal((cfg.num_codebooks, cfg.vocab, d), d**-0.5,
                                          torch.float32)}
    else:
        params = {"embed": normal((cfg.vocab, d), d**-0.5,
                                  torch.float32 if cfg.tie_embeddings else dt)}
    if cfg.vision_tokens:
        params["vision_proj"] = normal((cfg.vision_dim, d), 1 / math.sqrt(cfg.vision_dim))
    params["layers"] = [layer(spec) for spec in cfg.layer_specs()]
    params["ln_f"] = zeros(d)
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab), 1 / math.sqrt(d), torch.float32)
    return params


def from_jax_params(tree, cfg: ModelConfig, *, device=None,
                    param_dtype: Optional[torch.dtype] = None) -> Params:
    """Convert a ``repro.models.transformer.init_model`` tree whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, params)``) into this
    package's parameter dict on ``device``, matmul weights and an untied
    embedding in ``param_dtype`` (default: the compute dtype)."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    dt = _param_dtype(cfg, param_dtype)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    per_layer: List[dict] = []
    n_pattern = len(cfg.layer_pattern)
    for p in range(cfg.n_periods):
        for j in range(n_pattern):
            per_layer.append(_jax_layer(tree["layers"][j], p))
    for r in tree["layers_rem"]:
        per_layer.append(_jax_layer(r, None))
    layers_out = []
    for lp in per_layer:
        out = {k: t(v, dt if k in _MATMUL_KEYS else torch.float32)
               for k, v in lp.items() if k not in ("mamba", "moe", "cross")}
        if "cross" in lp:
            out["cross"] = {k: t(v, dt if k in _MATMUL_KEYS else torch.float32)
                            for k, v in lp["cross"].items()}
        if "mamba" in lp:
            out["mamba"] = {k: t(v, dt if k in _SSM_CAST_KEYS else torch.float32)
                            for k, v in lp["mamba"].items()}
        if "moe" in lp:
            out["moe"] = {k: t(v, torch.float32 if k == "router" else dt)
                          for k, v in lp["moe"].items() if k != "shared"}
            if "shared" in lp["moe"]:
                out["moe"]["shared"] = {k: t(v, dt) for k, v in lp["moe"]["shared"].items()}
        layers_out.append(out)
    embed = tree["embed"]
    params = {
        "embed": (t(embed["table_kvd"]) if "table_kvd" in embed else
                  t(embed["table_vd"], torch.float32 if cfg.tie_embeddings else dt)),
        "layers": layers_out,
        "ln_f": t(tree["ln_f"]["scale_r"]),
    }
    if not cfg.tie_embeddings:
        params["head"] = t(tree["head"]["w_dm"])
    if "vision_proj" in tree:
        params["vision_proj"] = t(tree["vision_proj"]["w_dm"], dt)
    return params


def _jax_attention(a, pick) -> dict:
    out = dict(wq=pick(a["wq_dm"]), wk=pick(a["wk_dm"]), wv=pick(a["wv_dm"]),
               wo=pick(a["wo_md"]))
    if "q_norm" in a:
        out.update(q_norm=pick(a["q_norm"]["scale_r"]), k_norm=pick(a["k_norm"]["scale_r"]))
    return out


def _jax_layer(tree, period: Optional[int]) -> dict:
    pick = (lambda a: np.asarray(a)[period]) if period is not None else np.asarray
    out = {"ln1": pick(tree["ln1"]["scale_r"])}
    if "attn" in tree:
        out.update(_jax_attention(tree["attn"], pick))
    if "mamba" in tree:
        m = tree["mamba"]
        out["mamba"] = {
            "win": pick(m["win_dm"]), "conv_w": pick(m["conv_w"]),
            "conv_b": pick(m["conv_b_r"]), "a_log": pick(m["a_log_r"]),
            "d_skip": pick(m["d_skip_r"]), "dt_bias": pick(m["dt_bias_r"]),
            "norm": pick(m["norm"]["scale_r"]), "wout": pick(m["wout_md"]),
        }
    if "ln_attn_out" in tree:
        out.update(ln_attn_out=pick(tree["ln_attn_out"]["scale_r"]),
                   ln_mamba_out=pick(tree["ln_mamba_out"]["scale_r"]))
    if "cross" in tree:
        out.update(ln_cross=pick(tree["ln_cross"]["scale_r"]),
                   cross=_jax_attention(tree["cross"], pick),
                   cross_gate=pick(tree["cross_gate_r"]))
    if "mlp" in tree:
        m = tree["mlp"]
        out.update(ln2=pick(tree["ln2"]["scale_r"]), w_gate=pick(m["wi_gate_dm"]),
                   w_up=pick(m["wi_up_dm"]), w_down=pick(m["wo_md"]))
    if "moe" in tree:
        m = tree["moe"]
        out["ln2"] = pick(tree["ln2"]["scale_r"])
        out["moe"] = {mine: pick(m[theirs]) for mine, theirs in _MOE_KEYS.items()}
        if "shared" in m:
            sh = m["shared"]
            out["moe"]["shared"] = {"w_gate": pick(sh["wi_gate_dm"]),
                                    "w_up": pick(sh["wi_up_dm"]), "w_down": pick(sh["wo_md"])}
    return out


def _embed_tokens(params, cfg: ModelConfig, tokens):
    dt = device_lib.dtype_of(cfg.compute_dtype)
    if cfg.num_codebooks > 1:
        # tokens (..., K): the codebooks' rows summed in float32, in order.
        tab, tokens = params["embed"], tokens.long()
        x = tab[0][tokens[..., 0]].float()
        for k in range(1, cfg.num_codebooks):
            x = x + tab[k][tokens[..., k]].float()
        return x.to(dt)
    return layers.embed(params["embed"], tokens, scale_by_dim=cfg.embed_scale,
                        compute_dtype=dt)


def _logits(params, cfg: ModelConfig, x):
    if cfg.num_codebooks > 1:
        # (B, S, D) x (K, V, D) -> (B, S, K, V): one product with the
        # float32 table as (K V, D).
        tab = params["embed"]
        logits = (x.float() @ tab.reshape(-1, tab.shape[-1]).T).reshape(
            *x.shape[:-1], *tab.shape[:2])
    elif cfg.tie_embeddings:
        return layers.unembed(params["embed"], x, softcap=cfg.final_softcap)
    else:
        logits = x.float() @ params["head"]
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _mlp(lp, x):
    return layers.mlp(lp["w_gate"], lp["w_up"], lp["w_down"], layers.rmsnorm(lp["ln2"], x))


#: The JAX stack's aux losses, in the order ``_train_layer`` returns them.
_AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac")


def _cross(lp, x, cfg: ModelConfig, spec: LayerSpec, mode: str, *, enc=None,
           cache: Optional[dict] = None, lengths=None) -> torch.Tensor:
    """A cross layer's gated block in ``mode`` ("train", "prefill" or
    "decode"): ``x + tanh(cross_gate) * cross_attn(rmsnorm(ln_cross, x))``.
    Training and prefill attend ``enc``, the projected image embeddings;
    prefill stores their K/V in the layer's ``cache`` dict under
    ``"cross"``, and decode reads them there. Training without images runs
    the block's weights as causal self-attention, as the JAX package does."""
    hc = layers.rmsnorm(lp["ln_cross"], x)
    gate = torch.tanh(lp["cross_gate"]).to(x.dtype)
    if mode == "decode":
        y, _ = attn_lib.attention_decode(lp["cross"], hc, cfg, spec, cache["cross"], lengths,
                                         is_cross=True)
    elif mode == "prefill":
        y, cache["cross"] = attn_lib.attention_prefill(
            lp["cross"], hc, cfg, spec, cache_len=enc.shape[1], encoder_states=enc)
    else:
        y = attn_lib.attention_block(lp["cross"], hc, cfg, spec, encoder_states=enc)
    return x + gate * y


def _mix(lp, x, cfg: ModelConfig, spec: LayerSpec, ya, ym, valid=None, cross=None):
    """The residual update of a layer's token mixer(s), then ``cross`` (a
    cross layer's gated block, a function of x), then its FFN: ``(x,
    aux)``, aux the MoE FFN's losses (None for other FFNs). hymba's hybrid
    layer normalizes and averages its parallel attention and SSM heads;
    ``valid`` marks the tokens an MoE FFN gives expert slots to."""
    if spec.kind == "attn":
        x = x + ya
    elif spec.kind == "mamba":
        x = x + ym
    else:
        x = x + 0.5 * (layers.rmsnorm(lp["ln_attn_out"], ya)
                       + layers.rmsnorm(lp["ln_mamba_out"], ym))
    if cross is not None:
        x = cross(x)
    if spec.ffn == "mlp":
        return x + _mlp(lp, x), None
    if spec.ffn == "moe":
        y, aux = moe_lib.moe_ffn(lp["moe"], layers.rmsnorm(lp["ln2"], x), cfg.moe,
                                 valid=valid)
        return x + y, aux
    return x, None


def _train_layer(lp, x, cfg: ModelConfig, spec, enc=None):
    """One layer of ``forward``: ``(x, lb, z, dropped)``, the last three the
    MoE losses (zero for other FFNs), as tensors so that
    ``torch.utils.checkpoint`` carries them. ``enc``: the projected image
    embeddings a cross layer attends (None: none given)."""
    h = layers.rmsnorm(lp["ln1"], x)
    ya = attn_lib.attention_block(lp, h, cfg, spec) if spec.kind in _ATTN_KINDS else None
    ym = (ssm_lib.mamba_train(lp["mamba"], h, cfg.d_model, cfg.ssm)
          if spec.kind in _SSM_KINDS else None)
    cross = (lambda x: _cross(lp, x, cfg, spec, "train", enc=enc)) if spec.cross_attn else None
    x, aux = _mix(lp, x, cfg, spec, ya, ym, cross=cross)
    if aux is None:
        return (x, *(torch.zeros((), dtype=torch.float32, device=x.device) for _ in _AUX_KEYS))
    return (x, *(aux[key] for key in _AUX_KEYS))


def _project_images(params, cfg: ModelConfig, image_embeds, dtype):
    """The cross layers' encoder states: ``image_embeds`` (B, vision_tokens,
    vision_dim) through ``vision_proj`` in ``dtype``, or None where the
    model or the caller has no images."""
    if not cfg.vision_tokens or image_embeds is None:
        return None
    return layers.linear(params["vision_proj"], image_embeds.to(dtype))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward: tokens (B, S) -> (logits (B, S, V) float32, aux);
    a multi-codebook model's (B, S, K) tokens give (B, S, K, V) logits.

    Every layer kind the port takes (``attn``, ``mamba``, ``hybrid``; ``ffn``
    ``"mlp"``, ``"moe"`` or ``"none"``), as the JAX package's ``forward``
    trains them, the MoE losses summed over the layers as its scan does:
    attention through ``ops.flash_attention`` (K1 forward, K5 / K6
    backward on the card), the SSM through ``ssm.mamba_train`` (K9 forward
    on the card, its backward written out in PyTorch ops, as the JAX
    package differentiates its XLA SSD), hymba's two mixers normalized and
    averaged. With ``remat`` each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass, as
    the JAX package's ``jax.checkpoint`` recomputes each period: only the
    layer inputs stay alive, and K1 and K9 run twice per layer.

    ``image_embeds`` (B, vision_tokens, vision_dim): the images that the
    cross layers attend, projected once per call (non-causal K1 forward,
    K5 / K6 backward on the card). Without them each cross layer runs its
    weights as causal self-attention, as the JAX ``forward`` does (ROADMAP
    Queue C: a departure the port copies)."""
    _check_supported(cfg)
    specs = cfg.layer_specs()
    x = _embed_tokens(params, cfg, tokens)
    enc = _project_images(params, cfg, image_embeds, x.dtype)
    aux = [torch.zeros((), dtype=torch.float32, device=x.device) for _ in _AUX_KEYS]
    for spec, lp in zip(specs, params["layers"]):
        if remat:
            x, *a = checkpoint(_train_layer, lp, x, cfg, spec, enc, use_reentrant=False)
        else:
            x, *a = _train_layer(lp, x, cfg, spec, enc)
        aux = [t + u for t, u in zip(aux, a)]
    x = layers.rmsnorm(params["ln_f"], x)
    return _logits(params, cfg, x), dict(zip(_AUX_KEYS, aux))


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_len: int, image_embeds: Optional[torch.Tensor] = None,
            last_positions: Optional[torch.Tensor] = None,
            prefix_caches: Optional[List[dict]] = None,
            page_table: Optional[torch.Tensor] = None,
            prefix_len: Optional[torch.Tensor] = None,
            plan=None) -> Tuple[torch.Tensor, List[dict]]:
    """Prefill: returns (logits at the last real position (B, V) float32,
    (B, K, V) for (B, S, K) tokens of a multi-codebook model, per-layer
    caches): ``{"k", "v"}`` of shape (B, Hkv, cache_len, hd) for
    attention, ``{"conv", "ssm"}`` for Mamba-2 blocks, both for hybrid
    layers; a cross layer adds ``"cross": {"k", "v"}``, the K/V of its
    encoder states (B, Hkv, vision_tokens, hd).

    ``image_embeds`` (B, vision_tokens, vision_dim): the images of a
    vision model, projected once per call; every row's queries attend all
    of its image's tokens. A model with cross layers raises ``ValueError``
    without them (the JAX ``prefill`` fails with an ``AttributeError``).

    ``last_positions`` (B,): each row's last real token in a right-padded
    batch (default S - 1); the SSM caches are those of the unpadded prompt,
    and the pads take no MoE expert slot.
    ``prefix_caches`` (the per-layer page pools) + ``page_table`` (B, pages)
    + ``prefix_len`` (B,): prefix-extension prefill of attention stacks —
    ``tokens`` holds only the tail, which attends to the prefix in place in
    its pages; the returned caches cover the tail only. ``plan`` is the
    caller-resolved extend plan (None lets each layer resolve its own).
    """
    x = _embed_tokens(params, cfg, tokens)
    b, s = tokens.shape[:2]
    enc = _project_images(params, cfg, image_embeds, x.dtype)
    if enc is None and any(spec.cross_attn for spec in cfg.layer_specs()):
        raise ValueError(f"{cfg.name}: prefill of a model with cross-attention layers needs "
                         "image_embeds (B, vision_tokens, vision_dim)")
    positions = tail_len = valid = None
    if last_positions is not None:
        valid = (torch.arange(s, device=x.device)[None, :]
                 <= last_positions.to(x.device).long()[:, None])
    if prefix_caches is not None:
        if page_table is None or prefix_len is None:
            raise ValueError("prefix-extension prefill needs page_table and prefix_len")
        positions = prefix_len.long()[:, None] + torch.arange(s, device=x.device)[None, :]
        tail_len = (last_positions + 1 if last_positions is not None
                    else torch.full((b,), s, device=x.device)).to(torch.int32)
    caches = []
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs(), params["layers"])):
        h = layers.rmsnorm(lp["ln1"], x)
        cache: dict = {}
        ya = ym = None
        if spec.kind in _ATTN_KINDS:
            if prefix_caches is not None:
                ya, c = attn_lib.attention_prefill_paged(
                    lp, h, cfg, spec, prefix_caches[i], page_table, prefix_len,
                    tail_len, cache_len=cache_len, positions=positions, plan=plan)
            else:
                ya, c = attn_lib.attention_prefill(lp, h, cfg, spec, cache_len=cache_len,
                                                   positions=positions)
            cache.update(c)
        if spec.kind in _SSM_KINDS:
            ym, c = ssm_lib.mamba_block(lp["mamba"], h, cfg.d_model, cfg.ssm,
                                        last_positions=last_positions)
            cache.update(c)
        caches.append(cache)
        cross = ((lambda x: _cross(lp, x, cfg, spec, "prefill", enc=enc, cache=cache))
                 if spec.cross_attn else None)
        x, _ = _mix(lp, x, cfg, spec, ya, ym, valid, cross)
    if last_positions is None:
        x = x[:, -1:]
    else:
        x = torch.gather(x, 1, last_positions.long()[:, None, None].expand(b, 1, x.shape[-1]))
    x = layers.rmsnorm(params["ln_f"], x)
    return _logits(params, cfg, x)[:, 0], caches


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                caches: List[dict], lengths: torch.Tensor, *,
                page_table: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[dict]]:
    """One decode step: returns (logits (B, V), caches).

    ``token`` (B,), or (B, K) for a multi-codebook model, whose logits are
    then (B, K, V); ``lengths`` (B,) int32 including the new token. With
    ``page_table`` (B, max_pages) int32 the caches are paged pools;
    without, dense per-row caches (``init_caches``, or views of them cut to
    the live rows and width). Either way they are updated in place.
    ``live`` (B,) bool: the rows that are a request's (default all); the
    others take no MoE expert slot. A cross layer reads the encoder K/V
    under ``"cross"`` in its dense cache, which it leaves as it is."""
    x = _embed_tokens(params, cfg, token[:, None])
    valid = None if live is None else live.to(x.device)[:, None]
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs(), params["layers"])):
        h = layers.rmsnorm(lp["ln1"], x)
        ya = ym = None
        if spec.kind in _ATTN_KINDS:
            if page_table is not None:
                ya, _ = attn_lib.attention_decode_paged(lp, h, cfg, spec, caches[i],
                                                        page_table, lengths)
            else:
                ya, _ = attn_lib.attention_decode(lp, h, cfg, spec, caches[i], lengths)
        if spec.kind in _SSM_KINDS:
            ym, _ = ssm_lib.mamba_decode(lp["mamba"], h, cfg.d_model, cfg.ssm, caches[i])
        cross = ((lambda x: _cross(lp, x, cfg, spec, "decode", cache=caches[i], lengths=lengths))
                 if spec.cross_attn else None)
        x, _ = _mix(lp, x, cfg, spec, ya, ym, valid, cross)
    x = layers.rmsnorm(params["ln_f"], x)
    return _logits(params, cfg, x)[:, 0], caches


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device,
                image_len: int = 0) -> List[dict]:
    """Zero dense caches, one dict per layer with the keys ``prefill``
    returns: ``(batch, Hkv, cache_len, hd)`` stripes for attention, the
    conv history and float32 state for Mamba-2 blocks, and for a cross
    layer ``"cross"`` stripes of ``max(image_len, 1)`` rows, as the JAX
    package sizes them."""
    _check_supported(cfg)
    dt = device_lib.dtype_of(cfg.compute_dtype)
    caches = []
    for spec in cfg.layer_specs():
        c: dict = {}
        if spec.kind in _ATTN_KINDS:
            c.update(attn_lib.init_cache(cfg, batch, cache_len, dt, device))
        if spec.kind in _SSM_KINDS:
            c.update(ssm_lib.init_mamba_cache(cfg.d_model, cfg.ssm, batch, dt, device))
        if spec.cross_attn:
            c["cross"] = attn_lib.init_cache(cfg, batch, max(image_len, 1), dt, device)
        caches.append(c)
    return caches


def init_paged_caches(cfg: ModelConfig, num_pages: int, page_size: int,
                      device, kv_dtype: str = "fp32") -> List[dict]:
    """One zero-filled head-major page pool per attention layer, all indexed
    by the same physical page ids (one allocator drives every layer); a
    quantized ``kv_dtype`` adds each layer's scale tables. Only pure
    self-attention stacks page: SSM state and cross-attention K/V are not
    page-structured, as in the JAX package."""
    _check_supported(cfg)
    for spec in cfg.layer_specs():
        if spec.kind != "attn" or spec.cross_attn:
            raise ValueError(
                "paged caches require a pure self-attention stack; "
                f"got layer kind={spec.kind!r} cross_attn={spec.cross_attn}")
    dt = device_lib.dtype_of(cfg.compute_dtype)
    return [attn_lib.init_paged_cache(cfg, num_pages, page_size, dt, device, kv_dtype)
            for _ in range(cfg.n_layers)]
