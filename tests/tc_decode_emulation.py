"""The arithmetic of the tensor-core decode kernels, written out in
float32 on the CPU: one walk, shared by K7/K8 (dense stripes,
``dense_decode_tc_kernel``), K3/K4 (paged pools, ``paged_decode_tc_kernel``)
and K3q/K4q (bf16 q over int8 or fp8 pools, ``paged_decode_q_tc_kernel``),
which run one consumer (``src/repro_torch/csrc/decode_tc.cuh``) and differ
only in where a tile's rows come from, where its first key sits, and, for
a quantized pool, the codes widened exactly and the page scales folded into
S's and P's columns. Beside it, the softcap of K1's, K2's and the head_dim
256 decode consumer (``softcap_log2``).

Not a test module: ``tests/test_torch_dense.py``,
``tests/test_torch_paged_tc.py``, ``tests/test_torch_kernels.py`` and
``tests/test_torch_paged_prefill_tc.py`` import it.
"""

import numpy as np
import torch

from repro_torch.cache import quant
from repro_torch.cache.layout import decode_split_ranges

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
TILE = 64   # rows of a K / V tile (dtc::BT)
ROW_TOL = 2.0**-6   # per row, against the row's max |o|: one bf16 ulp is 2^-7


def softcap_tanh(s, scale, softcap):
    """tanh(s * scale / softcap) as hopper.cuh's softcap_log2 computes it
    in float32: 1 - 2 / (2^(s k) + 1), k = 2 log2(e) scale (1 / softcap)
    rounded as the kernel rounds it (the power is inf past |y| ~ 44, and
    the result exactly +-1)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    k = f32(2.0) * f32(LOG2E) * f32(scale) * (1.0 / f32(softcap))
    return 1.0 - 2.0 / (torch.exp2(s * k) + 1.0)


def softcap_log2(s, scale, softcap):
    """hopper.cuh's softcap_log2 in float32: softcap * tanh(s * scale /
    softcap) * log2(e) as c * softcap_tanh(s, scale, softcap), c = softcap
    log2(e) rounded as the kernel rounds it."""
    c = torch.tensor(softcap, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    return c * softcap_tanh(s, scale, softcap)


def row_err(j, t) -> float:
    """Max over rows of max |t - j| / max |j|, j a JAX output (an all-zero
    row of j must be exactly zero in t)."""
    ref = torch.from_numpy(np.asarray(j, np.float32))
    diff = (t.float() - ref).abs().amax(-1)
    den = ref.abs().amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


def tensor_core_decode(q, hkv, cells, tile_kv, *, softcap=None):
    """The consumer's arithmetic, for q (B, Hq, D) over ``hkv`` kv heads.
    ``cells(b)`` gives one ``(first, lo, hi)`` per split of row b: the
    walk's first key and the positions it keeps; ``tile_kv(b, key0, hi)``
    gives the bf16 K and V rows (Hkv, n, D), n <= TILE, of the tile whose
    first key is ``key0`` or, over a quantized pool, their int8 or e4m3
    codes and the K and V scales of each row's page (Hkv, n).

    Tiles of 64 keys from ``first``, the four warps of a block (two for
    each m16 tile when the group exceeds 16) taking whole tiles in turn,
    each keeping its own online softmax: products of bf16 inputs summed in
    float32, scores in log2 units with scale * log2(e) folded into one
    multiply (a softcap first, in natural units), positions outside
    [lo, hi) masked, exp2, P rounded to bf16 before P V while the row sum
    takes P unrounded. The warps' states merge once (exp2 weights). One
    pass writes the normalised row; a split writes (acc, m ln 2, l), merged
    by the combine kernel in natural units. A softcap is tanh below head_dim
    256 and ``softcap_log2`` at 256, as the kernels compute it. At head_dim 256 all four warps
    take every tile (one state per cell): S is the sum, in warp order, of
    four partial products over 64-column chunks of D, and the row sum is
    kept per 16-key slice of a tile (a warp's) and the four slices' sums
    added in warp order at the end.

    Over a quantized pool the codes widen exactly (every int8 and e4m3
    value is a bf16 value), and positions outside [lo, hi) are zeros by
    select (their page may be the null page, NaN codes and scale and all);
    S = q codes^T is multiplied by each column's K scale before the
    softcap and scale, and P's columns by their V scales in float32, by
    select; P V takes that P as two bf16 parts, its rounding and the
    remainder's; the row sum takes P unscaled."""
    b, hq, d = q.shape
    group = hq // hkv
    chunks = 4 if d == 256 else 1   # partial products of S, summed in order
    warps = 1 if d == 256 else (4 if group <= 16 else 2)   # states taking tiles in turn
    slices = 4 if d == 256 else 1   # row sums kept per key slice
    scale = 1.0 / d**0.5
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    qf = q.float().reshape(b, hkv, group, d)
    out = torch.zeros(b, hkv, group, d)
    for bi in range(b):
        states = []
        for first, lo, hi in cells(bi):
            ntiles = -(-(hi - first) // TILE) if hi > lo else 0
            m = torch.full((warps, hkv, group), -1e30)
            l = torch.zeros((warps, slices, hkv, group))
            acc = torch.zeros((warps, hkv, group, d))
            for t in range(ntiles):
                w, t0 = t % warps, first + t * TILE
                kt, vt, *scales = tile_kv(bi, t0, hi)
                kt, vt = kt.float(), vt.float()
                pos = torch.arange(t0, t0 + kt.shape[1])[None, None, :]
                ok = (pos >= lo) & (pos < hi)
                if scales:
                    kt, vt = (torch.where(ok[0, 0, :, None], x, 0.0) for x in (kt, vt))
                dc = d // chunks
                s = None
                for c in range(chunks):
                    part = torch.einsum("hgd,htd->hgt", qf[bi][..., c * dc:(c + 1) * dc],
                                        kt[..., c * dc:(c + 1) * dc])
                    s = part if s is None else s + part
                if scales:
                    s = s * scales[0][:, None, :]
                if not softcap:
                    x = s * scale2
                elif d == 256:
                    x = softcap_log2(s, scale, softcap)
                else:
                    x = softcap * torch.tanh(s * scale / softcap) * LOG2E
                x = torch.where(ok, x, torch.tensor(-1e30))
                m_new = torch.maximum(m[w], x.amax(-1))
                alpha = torch.exp2(m[w] - m_new)
                p = torch.where(ok, torch.exp2(x - m_new[..., None]), torch.tensor(0.0))
                width = TILE // slices
                l[w] = l[w] * alpha[None] + torch.stack(
                    [p[..., j * width:(j + 1) * width].sum(-1) for j in range(slices)])
                if scales:
                    p = torch.where(ok, p * scales[1][:, None, :], torch.tensor(0.0))
                    p_hi = p.to(torch.bfloat16).float()
                    p = p_hi + (p - p_hi).to(torch.bfloat16).float()
                else:
                    p = p.to(torch.bfloat16).float()
                acc[w] = acc[w] * alpha[..., None] + torch.einsum("hgt,htd->hgd", p, vt)
                m[w] = m_new
            m_star = m.amax(0)
            wt = torch.exp2(m - m_star)
            l_sum = l[:, 0]
            for j in range(1, slices):
                l_sum = l_sum + l[:, j]
            l_star = (l_sum * wt).sum(0)
            acc_star = (acc * wt[..., None]).sum(0)
            states.append((acc_star, torch.where(l_star == 0, torch.tensor(-1e30),
                                                 m_star * LN2), l_star))
        if len(states) == 1:
            acc_star, _, l_star = states[0]
            out[bi] = acc_star / torch.where(l_star == 0, 1.0, l_star)[..., None]
        else:
            acc_s = torch.stack([s_[0] for s_ in states])
            m_s = torch.stack([s_[1] for s_ in states])[..., None]
            l_s = torch.stack([s_[2] for s_ in states])[..., None]
            m_all = m_s.amax(0)
            alpha = torch.exp(m_s - m_all)
            l_all = (l_s * alpha).sum(0)
            out[bi] = (acc_s * alpha).sum(0) / torch.where(l_all == 0, 1.0, l_all)
    return out.reshape(b, hq, d).to(torch.bfloat16)


def _range(lo, hi, length, window):
    """[lo, hi) cut to the positions a row of ``length`` tokens sees."""
    hi = min(hi, length)
    if window:
        lo = max(lo, length - window)
    return lo, hi


def dense_k7_k8(q, k, v, lengths, *, window=None, softcap=None, chunk=64, num_splits=1):
    """K7/K8 on stripes k / v (B, Hkv, Smax, D): each (b, split) cell reads
    rows [max(start, length - window), min(end, length)) of its
    chunk-granular range in 64-row tiles from its first row."""
    smax = k.shape[2]

    def cells(bi):
        length = int(lengths[bi])
        out = []
        for c_lo, c_hi in decode_split_ranges(smax // chunk, num_splits):
            lo, hi = _range(c_lo * chunk, min(c_hi * chunk, smax), length, window)
            out.append((lo, lo, hi))
        return out

    def tile_kv(bi, t0, hi):
        return k[bi, :, t0:t0 + TILE], v[bi, :, t0:t0 + TILE]

    return tensor_core_decode(q, k.shape[1], cells, tile_kv, softcap=softcap)


def paged_k3_k4(q, k_pages, v_pages, page_table, lengths, *, window=None, softcap=None,
                num_splits=1, k_scale_tab=None, v_scale_tab=None):
    """K3/K4 on head-major pools (Hkv, P, ps, D): each (b, split) cell keeps
    positions [max(start, length - window), min(end, length)) of its
    page-granular range and walks 64-row stages of 64 / ps pages from the
    page holding the first of them (the stage origin is page-aligned; the
    positions before it are masked). A stage's slots past the range's last
    live page hold that page again (masked). With (Hkv, P) scale tables the
    pools hold int8 or e4m3 codes: K3q/K4q, each row's scales its page's."""
    hkv, _, ps, d = k_pages.shape
    mp = page_table.shape[1]

    def cells(bi):
        length = int(lengths[bi])
        out = []
        for p_lo, p_hi in decode_split_ranges(mp, num_splits):
            lo, hi = _range(p_lo * ps, p_hi * ps, length, window)
            out.append(((lo // ps) * ps, lo, hi))
        return out

    def tile_kv(bi, t0, hi):
        last = (hi - 1) // ps
        ids = page_table[bi, [min(t0 // ps + i, last) for i in range(TILE // ps)]].long()
        kt, vt = (quant.index_pages(x, (slice(None), ids)).reshape(hkv, TILE, d)
                  for x in (k_pages, v_pages))
        if k_scale_tab is None:
            return kt, vt
        return (kt, vt) + tuple(t[:, ids].repeat_interleave(ps, dim=1)
                                for t in (k_scale_tab, v_scale_tab))

    return tensor_core_decode(q, hkv, cells, tile_kv, softcap=softcap)
