"""Core layers: RMSNorm, rotary embeddings, gated MLP, embedding, linear.

Port of ``repro.models.layers``, matching it operation for operation:
RMSNorm in float32 with eps 1e-6 and the ``(1 + scale)`` gain, split-half
rotary embeddings, and the SiLU-gated MLP. Functions take a tensor and the
weights they need; products run in the activations' dtype, as the JAX
package casts each weight to the compute dtype before its product.
"""

from __future__ import annotations

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
    gate = x @ w_gate
    up = x @ w_up
    return (F.silu(gate) * up) @ w_down


def embed(table: torch.Tensor, tokens: torch.Tensor, *, scale_by_dim: bool = False,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    x = table[tokens.long()].to(compute_dtype)
    if scale_by_dim:
        x = x * torch.tensor(table.shape[1] ** 0.5, dtype=compute_dtype)
    return x


def linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)
