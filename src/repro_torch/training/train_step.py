"""The training step: loss, gradients, microbatching, compression, AdamW.

Port of ``repro.training.train_step``. The JAX package builds a pure
function for ``jit`` with donated buffers; here the step runs eagerly and
updates the state in place:

  * gradients accumulate into each parameter's ``.grad`` over the
    microbatches (microbatch m = rows ``[m::n]``, the JAX package's strided
    split) and are averaged, as the JAX scan sums and scales them;
  * ``remat`` checkpoints each layer (``transformer.forward``);
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
    logits, aux = transformer.forward(params, cfg, batch["tokens"], remat=tcfg.remat)
    loss, metrics = layers.softmax_cross_entropy(logits, batch["targets"], batch["mask"],
                                                 z_loss=cfg.z_loss)
    # Only llama-family (dense MLP) layers are ported, so the MoE losses are
    # the zeros of the aux dict: the loss is the cross-entropy alone. The
    # MoE coefficients come back with the MoE port (ROADMAP Queue A).
    metrics = dict(metrics)
    metrics.update(moe_lb_loss=aux["moe_lb_loss"], moe_dropped=aux["moe_dropped_frac"])
    return loss, metrics


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


def _grads(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    n = tcfg.microbatches
    if n == 1:
        loss, metrics = loss_fn(params, cfg, batch, tcfg=tcfg)
        loss.backward()
        return tree_lib.map_tree(lambda p: p.grad, params), loss.detach(), metrics
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
        grads = tree_lib.map_tree(lambda p: p.grad.mul_(inv), params)
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
