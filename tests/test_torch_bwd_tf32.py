"""The float32 K5 / K6 (``fa2_dq_tf32_kernel`` / ``fa2_dkv_tf32_kernel`` in
``src/repro_torch/csrc/flash_attention_bwd.cu``), written out on the CPU
and held against the JAX package's Pallas backward.

No CPU runs the kernels, so their arithmetic is written out here in
float32: each operand split into hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna`` as int32 bit operations, as ``tests/test_torch_ssd_tc.py``
does for K9), each product of a k-step of 8 summed as lo hi' + hi lo' +
hi hi'; S and dP (K6: S^T and dP^T) with the two cross terms summed apart
from hi hi' over D and added at the end; P recomputed from lse with exp2
and scale * log2(e) folded in; P and dS split as the A operand of the next
product; the walk in the kernels' tiles: K5 a 64-row q tile against key
tiles of 32 (``kv_tile_range``), K6 a 64-row kv tile against the GQA
group's q tiles of 32 (causal from the tile's first key, a window to its
last), each walked tile cut into two halves of 16 rows whose sums (each
tile's two k-steps summed in a zeroed accumulator first) are added at the
end, in order. Masks
apply on the 16 x 16 warp tiles the kernels mark as edges; the test
checks that every tile they mark neither dead nor edge is wholly visible
and every dead tile wholly masked. The tensor core's own order of
summation inside an mma is not the order here: that is float32 rounding,
far below the bar.

The JAX side is ``repro.kernels.flash_attention_bwd`` in float32, interpret
mode (one block, as ``tests/test_torch_backward.py`` runs it). Held per
(b, head) slice at 1e-5 of the slice's max (the card's ``GRAD_F32_TOL``);
the same walk with hi hi' alone, one TF32 pass, misses that bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import HEAD_FIRST as J_HEAD_FIRST
from repro.kernels.flash_attention import MappingConfig as JaxMapping
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.kernels.flash_attention_bwd import flash_attention_bwd as jax_bwd

#: The kernels' tiles (namespace f32 of csrc/flash_attention_bwd.cu): own
#: rows of a block, rows of a walked tile, walked rows of a warp, own rows
#: of a warp.
OWN, WALK, WN, WM = 64, 32, 16, 16
LOG2E = 1.4426950408889634
ROW_DEAD = -1e30 / 2
#: Per (b, head) slice: max |g - ref| over max |ref| (GRAD_F32_TOL).
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small ops gain nothing from intra-op threads, and under pytest-xdist
    those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view (round half away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _scores(a, b, passes):
    """a (..., m, D) times b (..., n, D)^T by k-steps of 8 over D: hi hi'
    into one sum, the cross terms into another (``score_step``), added at
    the end; ``passes`` 1 keeps hi hi' alone."""
    (ahi, alo), (bhi, blo) = _split(a), _split(b)
    s = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
    s_x = torch.zeros_like(s)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            s_x = s_x + alo[..., ks] @ bhi[..., ks].transpose(-1, -2)
            s_x = s_x + ahi[..., ks] @ blo[..., ks].transpose(-1, -2)
        s = s + ahi[..., ks] @ bhi[..., ks].transpose(-1, -2)
    return s + s_x


def _tile_sum(a, b, passes):
    """A walked half's product (``mma_group``): a (..., m, 16) times b (...,
    16, D), two k-steps of 8 into a zeroed accumulator, each the three
    terms lo hi', hi lo', hi hi' in turn."""
    (ahi, alo), (bhi, blo) = _split(a), _split(b)
    part = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            part = part + alo[..., ks] @ bhi[..., ks, :]
            part = part + ahi[..., ks] @ blo[..., ks, :]
        part = part + ahi[..., ks] @ bhi[..., ks, :]
    return part


def _p_ds(s, dp, nl, delta, scale, softcap):
    """P = 2^(s scale log2(e) + nl) (``recompute_p``; nl = -lse log2(e),
    -inf for a dead row) and dS = P (dP - delta), times the softcap's
    chain-rule factor."""
    if softcap:
        th = torch.tanh(s * (_f32(scale) / _f32(softcap)))
        p = torch.exp2(_f32(softcap) * th * LOG2E + nl)
        return p, p * (dp - delta) * (1.0 - th * th)
    p = torch.exp2(s * (_f32(scale) * _f32(LOG2E)) + nl)
    return p, p * (dp - delta)


def _visible(rows, keys, live, causal, window):
    ok = (keys < live) & (rows >= 0)
    if causal:
        ok = ok & (keys <= rows)
    if window:
        ok = ok & (keys > rows - window)
    return ok


def _kv_tile_range(q0, live, causal, window):
    n_hi = -(-live // WALK)
    if causal:
        n_hi = min(n_hi, (q0 + OWN + WALK - 1) // WALK)
    edge = q0 - window + 1 if window else 0
    return (edge // WALK if edge > 0 else 0), n_hi


def _tile_kind(row0, key0, rows_n, keys_n, live, causal, window, sq):
    """The kernels' dead / edge test of a warp tile of rows_n q rows from
    row0 and keys_n keys from key0 (K5: 16 q rows by WN keys; K6: 16 keys
    by WN q rows)."""
    q_last, k_last = row0 + rows_n - 1, key0 + keys_n - 1
    dead = (row0 >= sq or key0 >= live or (causal and key0 > q_last)
            or bool(window and k_last <= row0 - window))
    edge = k_last >= live or (causal and k_last > row0) or bool(window and key0 <= q_last - window)
    return "dead" if dead else "edge" if edge else "full"


def _masked(p, ds, kind, ok):
    """P and dS of one warp tile as the kernel leaves them: the mask on an
    edge tile; a dead tile is skipped (its sums get nothing)."""
    if kind == "dead":
        assert not ok.any(), "a tile the kernel skips holds a visible pair"
        return torch.zeros_like(p), torch.zeros_like(ds)
    if kind == "full":
        assert ok.all(), "a tile the kernel does not mask holds a masked pair"
        return p, ds
    zero = torch.zeros(())
    return torch.where(ok, p, zero), torch.where(ok, ds, zero)


def _dead_log2(lse):
    return torch.where(lse > ROW_DEAD, -lse * LOG2E, torch.tensor(-float("inf")))


def _k5(q, k, v, do, lse, delta, *, causal, window, softcap, kv_len, passes):
    """dQ as fa2_dq_tf32_kernel computes it."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    live = min(skv, skv if kv_len is None else kv_len)
    scale = 1.0 / d**0.5
    kk, vv = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    s, dp = _scores(q, kk, passes), _scores(do, vv, passes)
    p, ds = _p_ds(s, dp, _dead_log2(lse)[..., None], delta[..., None], scale, softcap)
    ar_q, ar_k = torch.arange(sq)[:, None], torch.arange(skv)[None, :]
    ok = _visible(ar_q, ar_k, live, causal, window)
    dq = torch.zeros_like(q)
    for q0 in range(0, sq, OWN):
        n_lo, n_hi = _kv_tile_range(q0, live, causal, window)
        for r0 in range(q0, min(q0 + OWN, sq), WM):
            rs = slice(r0, min(r0 + WM, sq))
            halves = [torch.zeros((b, hq, rs.stop - r0, d)) for _ in range(WALK // WN)]
            for n in range(n_lo, n_hi):
                for h, acc in enumerate(halves):
                    c0 = n * WALK + WN * h
                    kind = _tile_kind(r0, c0, WM, WN, live, causal, window, sq)
                    if kind == "dead":
                        continue
                    ks = slice(c0, c0 + WN)
                    pad = c0 + WN - skv    # keys past Skv: zero rows of K, masked
                    ds_t = _masked(p[..., rs, ks], ds[..., rs, ks], kind, ok[rs, ks])[1]
                    k_t = kk[..., ks, :]
                    if pad > 0:
                        ds_t = torch.nn.functional.pad(ds_t, (0, pad))
                        k_t = torch.nn.functional.pad(k_t, (0, 0, 0, pad))
                    acc += _tile_sum(ds_t, k_t, passes)
            dq[..., rs, :] = scale * (halves[0] + halves[1])
    return dq


def _k6(q, k, v, do, lse, delta, *, causal, window, softcap, kv_len, passes):
    """dK and dV as fa2_dkv_tf32_kernel computes them."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    live = min(skv, skv if kv_len is None else kv_len)
    scale = 1.0 / d**0.5
    kk, vv = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    st, dpt = _scores(kk, q, passes), _scores(vv, do, passes)   # (b, hq, skv, sq)
    pt, dst = _p_ds(st, dpt, _dead_log2(lse)[..., None, :], delta[..., None, :], scale,
                    softcap)
    ok = _visible(torch.arange(sq)[None, :], torch.arange(skv)[:, None], live, causal, window)
    nm = -(-sq // WALK)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for c0 in range(0, skv, OWN):
        m_lo = c0 // WALK if causal else 0
        m_hi = nm if c0 < live else 0
        if window:
            m_hi = min(m_hi, (c0 + OWN - 1 + window - 1) // WALK + 1)
        for r0 in range(c0, min(c0 + OWN, skv), WM):
            rs = slice(r0, min(r0 + WM, skv))
            halves = [[torch.zeros((b, hkv, rs.stop - r0, d)) for _ in range(2)]
                      for _ in range(WALK // WN)]
            for g in range(group):
                heads = slice(g, hq, group)    # q head hk * group + g of every kv head
                for m in range(m_lo, m_hi):
                    for h, (acc_k, acc_v) in enumerate(halves):
                        p0 = m * WALK + WN * h
                        kind = _tile_kind(p0, r0, WN, WM, live, causal, window, sq)
                        if kind == "dead":
                            continue
                        cs = slice(p0, min(p0 + WN, sq))
                        p_t, ds_t = _masked(pt[:, heads, rs, cs], dst[:, heads, rs, cs], kind,
                                            ok[rs, cs])
                        q_t, do_t = q[:, heads, cs], do[:, heads, cs]
                        pad = p0 + WN - sq   # q rows past Sq: zero rows, dead columns
                        if pad > 0:
                            p_t, ds_t = (torch.nn.functional.pad(x, (0, pad)) for x in (p_t, ds_t))
                            q_t, do_t = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                                         for x in (q_t, do_t))
                        acc_v += _tile_sum(p_t, do_t, passes)
                        acc_k += _tile_sum(ds_t, q_t, passes)
            dk[..., rs, :] = scale * (halves[0][0] + halves[1][0])
            dv[..., rs, :] = halves[0][1] + halves[1][1]
    return dk, dv


def _slice_err(ref, got) -> float:
    """Max over (b, head) slices of max |got - ref| / max |ref| (an all-zero
    slice of ref must be exactly zero in got)."""
    ref = torch.from_numpy(np.array(ref, np.float32))
    diff = (got - ref).abs().flatten(2).amax(-1)
    den = ref.abs().flatten(2).amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


#: name -> (Hq, Hkv, Sq, Skv, D, flags): GQA 8 / 2 causal at both head dims,
#: a window with a softcap at both, not causal with Sq != Skv and kv_len,
#: and kv_len 0, where every row is fully masked.
CASES = {
    "gqa_causal_d64": (8, 2, 130, 130, 64, dict(causal=True)),
    "gqa_causal_d128": (8, 2, 130, 130, 128, dict(causal=True)),
    "window_softcap_d64": (8, 2, 130, 130, 64, dict(causal=True, window=50, softcap=30.0)),
    "window_softcap_d128": (4, 1, 100, 100, 128, dict(causal=True, window=37, softcap=20.0)),
    "noncausal_kvlen_d64": (8, 2, 100, 130, 64, dict(causal=False, kv_len=101)),
    "fully_masked_d64": (4, 2, 70, 70, 64, dict(causal=False, kv_len=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32_walk_matches_jax_pallas_backward(case):
    """The written-out 3xTF32 K5 / K6 within 1e-5 of the JAX Pallas
    backward per (b, head) slice; one TF32 pass (hi hi' alone) misses it on
    every gradient (where the gradient is not zero)."""
    hq, hkv, sq, skv, d, kw = CASES[case]
    rng = np.random.default_rng(90 + d + sq)
    q, do = (rng.standard_normal((1, hq, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, hkv, skv, d)).astype(np.float32) for _ in range(2))
    mc = JaxMapping(order=J_HEAD_FIRST, block_m=256, block_n=256)
    qj, kj, vj, doj = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jax_fwd(qj, kj, vj, mapping=mc, interpret=True, **kw)
    want = jax_bwd(qj, kj, vj, o, lse, doj, mapping=mc, interpret=True, **kw)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    ot, lt = (torch.from_numpy(np.array(x, np.float32)) for x in (o, lse))
    delta = (dot * ot).sum(-1)
    flags = dict(causal=kw["causal"], window=kw.get("window"), softcap=kw.get("softcap"),
                 kv_len=kw.get("kv_len"))
    for passes in (3, 1):
        got = (_k5(qt, kt, vt, dot, lt, delta, passes=passes, **flags),
               *_k6(qt, kt, vt, dot, lt, delta, passes=passes, **flags))
        errs = [_slice_err(w, g) for w, g in zip(want, got)]
        if passes == 3:
            assert max(errs) <= TOL, (case, errs)
        elif kw.get("kv_len") == 0:
            assert max(errs) == 0.0, errs    # nothing to round: every gradient is 0
        else:
            assert min(errs) > TOL, (case, errs)
    if kw.get("kv_len") is not None:     # keys past kv_len get no gradient
        assert float(got[1][:, :, kw["kv_len"]:].abs().amax()) == 0.0
