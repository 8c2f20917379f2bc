"""The training step: loss, gradients, microbatching, compression, AdamW.

Port of ``repro.training.train_step``. The JAX package builds a pure
function for ``jit`` with donated buffers; here the step runs eagerly and
updates the state in place:

  * gradients accumulate into each parameter's ``.grad`` over the
    microbatches (microbatch m = rows ``[m::n]``, the JAX package's strided
    split) and are averaged, as the JAX scan sums and scales them;
  * ``remat`` checkpoints each layer (``transformer.forward``);
  * a batch may carry ``image_embeds`` (B, vision_tokens, vision_dim) for
    a vision model's cross layers, split over microbatches as the tokens;
  * a multi-codebook model's (B, S, K) targets are scored against its
    (B, S, K, V) logits, the (B, S) mask broadcast over the K codebooks, as
    there;
  * the loss adds the MoE aux losses summed over the stack, weighted by
    ``moe_lb_coef`` and ``moe_z_coef``, as there;
  * ``grad_compression="int8_ef"`` quantizes the gradients with error
    feedback before AdamW, as there;
  * AdamW then writes the parameters and moments in place under
    ``torch.no_grad()``. Nothing in the state changes before the update
    starts, so a step that fails earlier leaves the state as it was; a
    ``RuntimeError`` inside the update is raised as ``StateWriteFailure``,
    which the trainer does not replay on the state it left.

State is ``{"params", "opt", "ef"?}``; parameters are float32 masters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as tree_lib
from repro_torch.distributed.fault_tolerance import StateWriteFailure
from repro_torch.kernels import plan as plan_lib
from repro_torch.models import layers, transformer
from repro_torch.optim import adamw, grad_compress


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1
    moe_lb_coef: float = 0.01
    moe_z_coef: float = 1e-3
    remat: bool = True
    grad_compression: str = "none"   # "none" | "int8_ef"
    # Kernel-schedule policy of the attention layers: None keeps the model
    # config's own; a paper mapping name pins a fixed launch order.
    attn_mapping: Optional[str] = None


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch of the data pipeline as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            tcfg: TrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = transformer.forward(params, cfg, batch["tokens"],
                                      image_embeds=batch.get("image_embeds"),
                                      remat=tcfg.remat)
    mask = batch["mask"]
    if cfg.num_codebooks > 1:
        mask = mask[..., None] * torch.ones_like(batch["targets"], dtype=torch.float32)
    loss, metrics = layers.softmax_cross_entropy(logits, batch["targets"], mask,
                                                 z_loss=cfg.z_loss)
    # Without an MoE layer the aux losses are zeros and the total is the
    # cross-entropy; the metrics are the JAX package's either way.
    total = (loss + tcfg.moe_lb_coef * aux["moe_lb_loss"]
             + tcfg.moe_z_coef * aux["moe_z_loss"])
    metrics = dict(metrics)
    metrics.update(moe_lb_loss=aux["moe_lb_loss"].detach(),
                   moe_dropped=aux["moe_dropped_frac"].detach())
    return total, metrics


def _accumulate_grads(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    """(grads, loss, metrics): the mean over ``tcfg.microbatches`` strided
    splits. ``grads`` is the tree of the parameters' ``.grad`` tensors. The
    parameters require grad only inside the call, so serving them afterwards
    builds no autograd graph."""
    leaves = tree_lib.leaves(params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    try:
        return _grads(params, cfg, batch, tcfg)
    finally:
        for p in leaves:
            p.requires_grad_(False)


def _grad_of(p: torch.Tensor) -> torch.Tensor:
    """``p.grad``, zeros where the loss does not reach ``p`` (a vision
    model's ``vision_proj`` on a batch without images), as ``jax.grad``
    gives."""
    if p.grad is None:
        p.grad = torch.zeros_like(p)
    return p.grad


def _grads(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    n = tcfg.microbatches
    if n == 1:
        loss, metrics = loss_fn(params, cfg, batch, tcfg=tcfg)
        loss.backward()
        return tree_lib.map_tree(_grad_of, params), loss.detach(), metrics
    if batch["tokens"].shape[0] % n:
        raise ValueError(f"batch of {batch['tokens'].shape[0]} rows does not split "
                         f"into {n} microbatches")
    loss_sum, m_sum = None, None
    for m in range(n):
        loss, metrics = loss_fn(params, cfg, {k: v[m::n] for k, v in batch.items()},
                                tcfg=tcfg)
        loss.backward()
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        m_sum = metrics if m_sum is None else {k: m_sum[k] + metrics[k] for k in m_sum}
    inv = 1.0 / n
    with torch.no_grad():
        grads = tree_lib.map_tree(lambda p: _grad_of(p).mul_(inv), params)
    return grads, loss_sum * inv, {k: v * inv for k, v in m_sum.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds tensors on the state's device (``to_device``)."""
    cfg = plan_lib.with_mapping(cfg, tcfg.attn_mapping)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        grads, loss, metrics = _accumulate_grads(params, cfg, batch, tcfg)
        ef = state.get("ef")
        if tcfg.grad_compression == "int8_ef" and ef is not None:
            grads, ef = grad_compress.compress_with_feedback(grads, ef)
        try:
            params, opt, opt_metrics = adamw.update(tcfg.optimizer, params, grads, opt)
        except RuntimeError as e:   # some leaves may be written already
            raise StateWriteFailure(f"AdamW update failed part-way: {e}") from e
        for p in tree_lib.leaves(params):
            p.grad = None
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss_total"] = loss
        new_state = {"params": params, "opt": opt}
        if ef is not None:
            new_state["ef"] = ef
        return new_state, metrics

    return train_step


def init_train_state(seed: int, cfg: ModelConfig, tcfg: TrainConfig, *, device=None):
    """Random float32 parameters from ``seed`` on ``device`` (default the
    card), their AdamW state and, for ``int8_ef``, the error feedback."""
    params = transformer.init_model(cfg, seed=seed, device=device,
                                    param_dtype=torch.float32)
    state = {"params": params, "opt": adamw.init(params, tcfg.optimizer)}
    if tcfg.grad_compression == "int8_ef":
        state["ef"] = grad_compress.init_error_feedback(params)
    return state
