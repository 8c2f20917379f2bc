"""Batched next-token sampling with per-row parameters.

Port of ``repro.serving.sampling``. Rows with ``temperature == 0`` take the
exact argmax. Other rows are softmax-sampled after the same top-k and top-p
rules (``repro/serving/sampling.py:42-59``: the k-th largest logit and ties
with it survive; top-p keeps the smallest prefix of the sorted distribution
whose mass reaches ``top_p``, the crossing token included).

Randomness is keyed per request and stream position: each stochastic row
draws from a ``torch.Generator`` seeded by ``(seed, stream_pos)``, so a
request's samples do not depend on which rows share its tick and resume
after preemption continues the same stream. The port keeps these
properties, not the JAX package's threefry bits.
"""

from __future__ import annotations

import torch

_MIN_TEMPERATURE = 1e-6


def _row_seed(seed: int, pos: int) -> int:
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF)


def _filtered_logits(logits: torch.Tensor, temperature: float, top_k: int,
                     top_p: float) -> torch.Tensor:
    """One row's ``(V,)`` logits after temperature, top-k and top-p."""
    v = logits.shape[-1]
    scaled = logits.float() / max(float(temperature), _MIN_TEMPERATURE)
    k = v if top_k <= 0 else min(max(int(top_k), 1), v)
    desc = torch.sort(scaled, descending=True).values
    masked = torch.where(scaled < desc[k - 1], torch.full_like(scaled, -torch.inf), scaled)
    probs = torch.softmax(masked, dim=-1)
    p_desc = torch.sort(probs, descending=True).values
    keep = (torch.cumsum(p_desc, dim=-1) - p_desc) < top_p
    cutoff = p_desc[max(int(keep.sum()) - 1, 0)]
    return torch.where(probs < cutoff, torch.full_like(masked, -torch.inf), masked)


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seed,
                  stream_pos) -> torch.Tensor:
    """``logits`` (B, V) -> (B,) int64 tokens on the logits' device. The
    parameter arguments are length-B sequences of Python numbers."""
    out = torch.argmax(logits, dim=-1)
    for i in range(logits.shape[0]):
        if float(temperature[i]) <= 0:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_row_seed(seed[i], stream_pos[i]))
        probs = torch.softmax(
            _filtered_logits(logits[i], temperature[i], top_k[i], top_p[i]), dim=-1)
        out[i] = torch.multinomial(probs, 1, generator=gen)[0]
    return out
