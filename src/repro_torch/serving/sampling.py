"""Batched next-token sampling with per-row parameters, in tensor ops only.

Port of ``repro.serving.sampling._sample_batch``. Rows with
``temperature <= 0`` take the exact argmax. Other rows are sampled after the
same top-k and top-p rules (``repro/serving/sampling.py:42-59``: the k-th
largest logit and ties with it survive; top-p keeps the smallest prefix of
the sorted distribution whose mass reaches ``top_p``, the crossing token
included).

Randomness is keyed per request and stream position: a stochastic row draws
by Gumbel-max, its noise a counter-based hash of (seed, stream_pos, vocab
index). A request's samples then depend on neither the rows that share its
tick nor the device's RNG state, and resume after preemption continues the
same stream. The port keeps these properties, not the JAX package's
threefry bits. Nothing here reads a tensor back to the host, so the sampler
runs inside a captured CUDA graph.
"""

from __future__ import annotations

import torch

_MIN_TEMPERATURE = 1e-6
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the product is
    taken in 16-bit halves, so no intermediate leaves 49 bits."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (``lowbias32``) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _gumbel(seed: torch.Tensor, stream_pos: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) float32 Gumbel noise, a function of (seed, stream_pos, index)
    only."""
    key = _mix32(_mix32(seed.long() & _MASK32) ^ (stream_pos.long() & _MASK32))
    idx = torch.arange(vocab, dtype=torch.int64, device=seed.device)
    bits = _mix32(_mix32(key[:, None] ^ idx[None, :]) ^ 0x9E3779B9)
    # 23 bits to a float32 in (0, 1), both ends excluded (exact: 24 bits
    # with the half).
    u = ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def sample_batch(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, seed: torch.Tensor,
                 stream_pos: torch.Tensor) -> torch.Tensor:
    """``logits`` (B, V) -> (B,) int64 tokens. Every parameter is a (B,)
    tensor on the logits' device: temperature and top_p float, top_k, seed
    and stream_pos integer."""
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature.float().clamp_min(_MIN_TEMPERATURE)[:, None]
    k = torch.where(top_k <= 0, v, top_k.clamp(1, v)).long()
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, (k - 1)[:, None])
    masked = scaled.masked_fill(scaled < kth, -torch.inf)
    probs = torch.softmax(masked, dim=-1)
    p_desc = torch.sort(probs, dim=-1, descending=True).values
    keep = (torch.cumsum(p_desc, dim=-1) - p_desc) < top_p.float()[:, None]
    cutoff = torch.gather(p_desc, 1, (keep.sum(-1) - 1).clamp_min(0)[:, None])
    masked = masked.masked_fill(probs < cutoff, -torch.inf)
    sampled = torch.argmax(masked + _gumbel(seed, stream_pos, v), dim=-1)
    return torch.where(temperature <= 0, greedy, sampled)


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seed,
                  stream_pos) -> torch.Tensor:
    """``logits`` (B, V) -> (B,) int64 tokens on the logits' device. The
    parameter arguments are length-B sequences of Python numbers; they go
    through :func:`sample_batch`, the program every decode tick runs."""
    dev = logits.device

    def col(values, dtype):
        return torch.tensor(list(values), dtype=dtype, device=dev)

    return sample_batch(logits, col(temperature, torch.float32), col(top_k, torch.int64),
                        col(top_p, torch.float32), col(seed, torch.int64),
                        col(stream_pos, torch.int64))
