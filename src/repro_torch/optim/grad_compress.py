"""Gradient compression: blockwise int8 with error feedback.

Port of ``repro.optim.grad_compress``: ``quantize`` / ``dequantize``
(symmetric int8 in blocks of ``BLOCK`` with one float32 scale per block),
``ErrorFeedback`` (the quantization residual, re-injected next step) and
``compress_with_feedback``. The train step applies it before AdamW, as the
JAX package does. ``compressed_psum``, the reduction across replicas, waits
for the distributed port (ROADMAP Queue A 8).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tree as tree_lib

BLOCK = 2048


class Compressed(NamedTuple):
    q: torch.Tensor       # int8 payload, (blocks, BLOCK)
    scale: torch.Tensor   # float32 per-block scales


def quantize(x: torch.Tensor, block: int = BLOCK) -> Compressed:
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Compressed(q=q, scale=scale[:, 0])


def dequantize(c: Compressed, shape, dtype=torch.float32) -> torch.Tensor:
    flat = (c.q.float() * c.scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


class ErrorFeedback(NamedTuple):
    residual: Any  # tree like grads, float32


def init_error_feedback(grads_like) -> ErrorFeedback:
    return ErrorFeedback(residual=tree_lib.map_tree(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def compress_with_feedback(grads, ef: ErrorFeedback) -> Tuple[Any, ErrorFeedback]:
    """Quantize (grad + residual) and keep the new residual. Returns the
    dequantized tree (what the wire would deliver) and the new feedback."""

    def one(g, r):
        target = g.float() + r
        deq = dequantize(quantize(target), g.shape)
        return deq.to(g.dtype), target - deq

    pairs = tree_lib.map_tree(one, grads, ef.residual)   # (deq, residual) leaves
    deq = tree_lib.map_tree(lambda g, pr: pr[0], grads, pairs)
    res = tree_lib.map_tree(lambda g, pr: pr[1], grads, pairs)
    return deq, ErrorFeedback(residual=res)
