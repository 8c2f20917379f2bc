"""Core layers: RMSNorm, rotary embeddings, gated MLP, embedding, linear,
and the training loss.

Port of ``repro.models.layers``, matching it operation for operation:
RMSNorm in float32 with eps 1e-6 and the ``(1 + scale)`` gain, split-half
rotary embeddings, the SiLU-gated MLP, the tied float32 unembedding and
the float32 softmax cross-entropy with z-loss. Functions take a tensor and the weights they
need; each weight is cast to the activations' dtype at its product, as the
JAX package does, so float32 training masters and bf16 serving weights
take the same code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def rotary_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rotary(x: torch.Tensor, positions: torch.Tensor,
                 theta: float = 10000.0) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) or (S,) absolute positions."""
    d = x.shape[-1]
    freqs = rotary_freqs(d, theta, device=x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # (B, S, D/2)
    cos = torch.cos(angles)[:, None]                       # (B, 1, S, D/2)
    sin = torch.sin(angles)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    gate = x @ w_gate.to(dtype)
    up = x @ w_up.to(dtype)
    return (F.silu(gate) * up) @ w_down.to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor, *, scale_by_dim: bool = False,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    x = table[tokens.long()].to(compute_dtype)
    if scale_by_dim:
        x = x * torch.tensor(table.shape[1] ** 0.5, dtype=compute_dtype)
    return x


def unembed(table: torch.Tensor, x: torch.Tensor, *,
            softcap: Optional[float] = None) -> torch.Tensor:
    """Vocab logits through the tied embedding table (V, D), in float32."""
    logits = x.float() @ table.float().T
    if softcap is not None and softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, *,
                          z_loss: float = 0.0) -> Tuple[torch.Tensor, dict]:
    """Mean token cross-entropy in float32 with an optional z-loss.

    logits (..., V); targets (...) integer; mask (...) 0/1. Returns
    ``(loss, {"loss", "accuracy", "tokens"})``; the metrics are detached."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss > 0.0:
        nll = nll + z_loss * lse**2
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    with torch.no_grad():
        hits = (logits.argmax(-1) == targets.long()).float()
        acc = (hits * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": acc, "tokens": denom.detach()}
