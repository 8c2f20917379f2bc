"""K9's tensor-core arithmetic and its group-shaped, strided inputs, on the
CPU.

``csrc/ssd.cu`` runs the three products of the SSD intra-chunk block as
3xTF32 ``mma.sync m16n8k8``: each float32 operand x is split into hi =
tf32(x) and lo = tf32(x - hi) (``cvt.rna``: round to nearest, ties away
from zero, on the 13 low mantissa bits), and each k-step of 8 adds lo·hi',
hi·lo' and hi·hi' to a float32 accumulator. ``_k9_tensor_cores`` writes
that out in float32, walking the kernel's tiles in its order: 128 query
rows at a time, key tiles of 64 (32 at N 128, P 128) up to the diagonal,
C Bᵀ over k-steps of 8, the decay masked in log space before exp, W X over
k-steps of 8 keys, and the chunk state Xᵀ (B dte) on the last query tile's
walk, the decay on B (N 16) or on X (N 128), rebuilt from its hi and lo as
the kernel does.

Bars: against the JAX package's ``ssd_intra_chunk`` in interpret mode,
``SCAN_TOL`` (1e-3 absolute, ``tests/test_torch_ssm.py``'s bar for the
Pallas SSD); against the plain version in float64, ``SSD_TOL`` (1e-5 of
each (b, chunk, head) slice's max, the card's bar for K9 against its plain
version: about 22 bits a product, float32 sums over at most q + N terms).
acum spans -60..0 in one head and -100..0 in the other: above the diagonal
seg reaches +100, where exp overflows float32, so a mask applied after the
exp would give inf · 0 = NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ssd as jax_ssd

from repro_torch.kernels import ssd

SCAN_TOL = 1e-3
SSD_TOL = 1e-5
BM = 128            # query rows per tile (csrc/ssd.cu SSD_BM)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops gain nothing from intra-op threads, and under pytest-xdist
    those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view: add half of the dropped 13 bits'
    range to the magnitude, then clear them (sign-magnitude, so a negative
    value also rounds away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma3(acc, a, b):
    """One k-step of 8 in 3xTF32: acc += lo·hi' + hi·lo' + hi·hi'."""
    (ahi, alo), (bhi, blo) = _split(a), _split(b)
    acc = acc + alo @ bhi
    acc = acc + ahi @ blo
    return acc + ahi @ bhi


def _k9_tensor_cores(xdt, bh, ch, acum):
    """The kernel's arithmetic in float32, JAX layout, one B/C per head:
    returns ``(y (B,nc,H,q,P), s (B,nc,H,N,P))``."""
    b, nc, h, q, p = xdt.shape
    n = bh.shape[-1]
    bk = 32 if n >= 64 and p >= 128 else 64
    nq = -(-q // BM)
    qpad = nq * BM
    x, bm, cm = (F.pad(t, (0, 0, 0, qpad - q)) for t in (xdt, bh, ch))   # rows past q: 0
    a = F.pad(acum, (0, qpad - q))
    pos = torch.arange(qpad)
    dte = torch.where(pos < q, torch.exp(acum[..., q - 1:q] - a), torch.tensor(0.0))
    y = torch.zeros((b, nc, h, qpad, p))
    s = torch.zeros((b, nc, h, p, n))        # s^T, as the kernel holds it
    nk_all = -(-q // bk)
    for qt in range(nq):
        i0 = qt * BM
        rows = slice(i0, i0 + BM)
        yt = torch.zeros((b, nc, h, BM, p))
        for kt in range(min(nk_all, (i0 + BM) // bk)):     # causal key tiles only
            j0 = kt * bk
            keys = slice(j0, j0 + bk)
            sc = torch.zeros((b, nc, h, BM, bk))
            for kk in range(0, n, 8):
                sc = _mma3(sc, cm[..., rows, kk:kk + 8],
                           bm[..., keys, kk:kk + 8].transpose(-1, -2))
            ok = (pos[keys][None, :] <= pos[rows][:, None]) & (pos[rows][:, None] < q)
            seg = torch.where(ok, a[..., rows, None] - a[..., None, keys],
                              torch.tensor(ssd.NEG_INF))
            w = sc * torch.exp(seg)
            for k0 in range(0, bk, 8):
                yt = _mma3(yt, w[..., k0:k0 + 8], x[..., j0 + k0:j0 + k0 + 8, :])
            if qt == nq - 1:
                for k0 in range(j0, j0 + bk, 8):
                    # The decay scales B at N 16 and X otherwise, rebuilt
                    # from the split planes (hi + lo) as the kernel does.
                    xs, bs = x[..., k0:k0 + 8, :], bm[..., k0:k0 + 8, :]
                    d = dte[..., k0:k0 + 8, None]
                    if n <= 32:
                        bs = sum(_split(bs)) * d
                    else:
                        xs = sum(_split(xs)) * d
                    s = _mma3(s, xs.transpose(-1, -2), bs)
        y[..., rows, :] = yt
    return y[..., :q, :], s.transpose(-1, -2)


def _slice_rel(a, ref) -> float:
    """max |a - ref| over max |ref| per (b, chunk, head) slice, the worst."""
    a, ref = torch.as_tensor(np.asarray(a, np.float64)), ref.double()
    diff = (a - ref).abs().flatten(-2).amax(-1)
    return float((diff / ref.abs().flatten(-2).amax(-1).clamp_min(1e-300)).max())


def _inputs(rng, b, nc, h, q, p, n, spans):
    """xdt, bh, ch standard normal (dt-scaled x); acum a decreasing
    cumsum from ~0 down to -span of its head."""
    xdt = rng.standard_normal((b, nc, h, q, p)).astype(np.float32)
    bh = rng.standard_normal((b, nc, h, q, n)).astype(np.float32)
    ch = rng.standard_normal((b, nc, h, q, n)).astype(np.float32)
    steps = rng.exponential(1.0, (b, nc, h, q))
    acum = -np.cumsum(steps, -1) / steps.sum(-1, keepdims=True)
    acum = (acum * np.asarray(spans)[None, None, :, None]).astype(np.float32)
    return xdt, bh, ch, acum


@pytest.mark.parametrize("q", [256, 200, 32])
@pytest.mark.parametrize("n,p", ssd.SHAPES)
def test_tensor_core_k9_arithmetic_matches_jax(n, p, q):
    rng = np.random.default_rng(70 + n + p + q)
    args = _inputs(rng, 1, 1, 2, q, p, n, spans=(60.0, 100.0))
    yj, sj = jax_ssd.ssd_intra_chunk(*[jnp.asarray(t) for t in args], interpret=True)
    yt, st = _k9_tensor_cores(*[torch.from_numpy(t) for t in args])
    assert torch.isfinite(yt).all() and torch.isfinite(st).all()
    assert float(np.max(np.abs(np.asarray(yj) - yt.numpy()))) < SCAN_TOL
    assert float(np.max(np.abs(np.asarray(sj) - st.numpy()))) < SCAN_TOL
    y64, s64 = ssd.ssd_intra_chunk_plain(*[torch.from_numpy(t).double() for t in args])
    assert _slice_rel(yt, y64) <= SSD_TOL
    assert _slice_rel(st, s64) <= SSD_TOL


@pytest.mark.parametrize("g", [1, 2])
def test_plain_route_groups_and_strided_views(g):
    """B and C per group (H 4 over G 1 or 2) and strided views in the layout
    ``ssd_chunked_cuda`` passes (B / C a 16-byte-aligned slice of a wider
    row) give the bits of the per-head, contiguous call, on both entries."""
    rng = np.random.default_rng(80 + g)
    b, nc, q, h, p, n = 2, 2, 40, 4, 64, 16
    rep = h // g
    xdt = torch.from_numpy(rng.standard_normal((b, nc, q, h, p)).astype(np.float32))
    wide = torch.from_numpy(rng.standard_normal((2, b, nc, q, g, n + 8)).astype(np.float32))
    bq, cq = wide[0, ..., 4:4 + n], wide[1, ..., 4:4 + n]            # (B,nc,q,G,N) views
    acum = torch.from_numpy(np.cumsum(-rng.exponential(0.3, (b, nc, q, h)), 2)
                            .astype(np.float32))
    assert not bq.is_contiguous()
    perm = (0, 1, 3, 2, 4)

    def per_head(t):
        return t.repeat_interleave(rep, dim=3).permute(perm).contiguous()

    y_ref, s_ref = ssd.ssd_intra_chunk(xdt.permute(perm).contiguous(), per_head(bq),
                                       per_head(cq), acum.permute(0, 1, 3, 2).contiguous())
    y, s = ssd.ssd_intra_chunk(xdt.permute(perm), bq.permute(perm), cq.permute(perm),
                               acum.permute(0, 1, 3, 2))
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    y, s = ssd.ssd_intra_chunk_seq(xdt, bq, cq, acum)
    assert y.shape == (b, nc, q, h, p) and s.shape == (b, nc, h, p, n)
    assert torch.equal(y, y_ref.permute(perm)) and torch.equal(s, s_ref.transpose(-1, -2))
