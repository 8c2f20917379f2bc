"""KV-tile traversal order (the port's copy of ``repro.core.swizzle``'s
``kv_tile_order``).

``linear`` walks a sweep's KV tiles in ascending order every time;
``sawtooth`` reverses odd sweeps, so consecutive sweeps meet at a shared
boundary tile (on Hopper the tile is L2-hot when the next q block starts).
The CUDA prefill kernel computes the same index (``csrc/flash_attention.cu``).
"""

from __future__ import annotations

LINEAR = "linear"
SAWTOOTH = "sawtooth"
TRAVERSALS = (LINEAR, SAWTOOTH)


def kv_tile_order(traversal: str, sweep, n, num_n: int):
    """Effective KV tile index for step ``n`` of sweep ``sweep``."""
    if traversal == LINEAR:
        return n
    if traversal != SAWTOOTH:
        raise ValueError(f"unknown traversal {traversal!r}")
    rev = sweep % 2
    return (1 - rev) * n + rev * (num_n - 1 - n)
