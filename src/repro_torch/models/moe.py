"""Mixture-of-Experts FFN: top-k routing with capacity-bounded dispatch.

Port of ``repro.models.moe`` (Mixtral 8 experts top-2, Moonlight 64 top-6),
operation for operation: a float32 router, softmax, the top k gates
renormalised, the Switch load-balance loss and the router z-loss; each
(token, slot) takes a rank in its expert by a token-major cumulative
count, slots past the capacity ``C = max(8, min(ceil(n k / E cf), n))``
are dropped (gate zero); tokens go to (E, C, D) buffers, the SwiGLU
expert products run as batched matmuls in the compute dtype over every
expert, and the outputs come back weighted by their gates, plus the shared
expert where there is one. No Pallas kernel is involved in the JAX
package either: its expert products are ``einsum`` outside any kernel.

Shapes are static and nothing is read on the host, so the layer runs
inside a captured CUDA graph; the capacity is a Python int from the
call's ``B * S``. Every float sum has a fixed order (no atomics in the
forward pass): token -> slot is one ``index_copy`` (kept slots are
unique; dropped ones all land on a trash row that is never read), slot ->
token a gather and a sum over the k slots in slot order.

One departure, on purpose (ROADMAP Queue C): ``valid`` marks the tokens
that are a request's. The JAX package gives every token of the call a
slot, pads and frozen decode rows included, so a row's pads can push the
next rows' real tokens out of an expert. Here a token outside ``valid``
takes no slot and adds nothing to the aux losses; with ``valid=None``
(training, an unpadded call) the function is the JAX package's.

Parameters, under a layer's ``"moe"`` key::

    {"router": (D, E) float32, "w_gate", "w_up": (E, D, F), "w_down": (E, F, D),
     "shared": {"w_gate", "w_up": (D, F S), "w_down": (F S, D)}   (S shared experts)}

``route`` is the one routing function ``moe_ffn`` calls, looked up on
this module at each call.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, *, dtype,
             device) -> dict:
    """Random weights with the distributions of ``repro.models.moe.init_moe``:
    normal, scaled by 1/sqrt(fan_in); the router stays float32, the expert
    stacks and the shared expert are ``dtype``."""
    e, f = cfg.num_experts, cfg.d_ff

    def normal(shape, scale, dt=dtype):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dt)

    s_in = 1.0 / math.sqrt(d_model)
    p = {"router": normal((d_model, e), s_in, torch.float32),
         "w_gate": normal((e, d_model, f), s_in),
         "w_up": normal((e, d_model, f), s_in),
         "w_down": normal((e, f, d_model), 1.0 / math.sqrt(f))}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"w_gate": normal((d_model, fs), s_in),
                       "w_up": normal((d_model, fs), s_in),
                       "w_down": normal((fs, d_model), 1.0 / math.sqrt(fs))}
    return p


def route(logits: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 router logits (n, E) -> (probs (n, E), gates (n, k), expert
    ids (n, k) int64): the softmax, its k largest in descending order, the
    lower expert id first on an exact tie (as ``jax.lax.top_k``: a stable
    sort), and the gates renormalised to sum to 1."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gates, idx[:, :top_k]


def capacity_of(n: int, cfg: MoEConfig) -> int:
    """Slots per expert for a call of ``n`` tokens (the JAX package's)."""
    c = int(math.ceil(n * cfg.top_k / cfg.num_experts * cfg.capacity_factor))
    return max(8, min(c, n))


def _mean(t: torch.Tensor, w: Optional[torch.Tensor], count) -> torch.Tensor:
    """Mean over dim 0, over the rows ``w`` marks when given."""
    if w is None:
        return t.mean(dim=0)
    return (t * w.reshape(-1, *([1] * (t.ndim - 1)))).sum(dim=0) / count


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
            capacity: Optional[int] = None, valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D), aux ``{moe_lb_loss, moe_z_loss,
    moe_dropped_frac}``). ``valid`` (B, S) bool: the tokens that are a
    request's (None: all); ``capacity`` overrides the slots per expert."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(n, d)
    dt = xt.dtype

    logits = xt.float() @ params["router"].float()
    probs, gates, idx = route(logits, k)

    experts = torch.arange(e, device=x.device)
    w = count = None
    if valid is not None:
        w = valid.reshape(n).float()
        count = torch.clamp(w.sum(), min=1.0)
    me = _mean(probs, w, count)
    ce = _mean((idx[..., None] == experts).float().sum(dim=1), w, count)
    lb_loss = e * torch.sum(me * ce) / k
    z_loss = _mean(torch.logsumexp(logits, dim=-1) ** 2, w, count)

    if capacity is None:
        capacity = capacity_of(n, cfg)
    flat = idx.reshape(-1)                                   # (n k,), token-major
    # The one-hot is built expert-major, (E, n k), so the count runs along
    # the last dim: a scan down dim 0 of (n k, E) is one thread a column.
    onehot = (experts[:, None] == flat[None, :]).int()
    valid_slot = None
    if valid is not None:
        valid_slot = valid.reshape(n, 1).expand(n, k).reshape(-1)
        onehot = onehot * valid_slot[None, :].int()
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(rank, 0, flat[None, :])[0]
    keep = pos < capacity
    if valid_slot is not None:
        keep = keep & valid_slot
    gate_flat = gates.reshape(-1) * keep.float()

    trash = e * capacity
    slot = torch.where(keep, flat * capacity + pos, trash)
    buf = xt.new_zeros((trash + 1, d)).index_copy(
        0, slot, xt[:, None, :].expand(n, k, d).reshape(n * k, d))
    buf = buf[:trash].reshape(e, capacity, d)
    h = (F.silu(torch.bmm(buf, params["w_gate"].to(dt)))
         * torch.bmm(buf, params["w_up"].to(dt)))
    out_flat = torch.bmm(h, params["w_down"].to(dt)).reshape(trash, d)

    gathered = out_flat[torch.where(keep, slot, 0)] * gate_flat[:, None].to(dt)
    gathered = gathered.reshape(n, k, d)
    out = gathered[:, 0]
    for j in range(1, k):
        out = out + gathered[:, j]
    if "shared" in params:
        sh = params["shared"]
        out = out + layers.mlp(sh["w_gate"], sh["w_up"], sh["w_down"], xt)

    if valid_slot is None:
        kept = keep.float().mean()
    else:
        kept = keep.float().sum() / (count * k)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss, "moe_dropped_frac": 1.0 - kept}
    return out.reshape(b, s, d), aux
