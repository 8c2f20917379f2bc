"""Kernel modules of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (Pallas in interpret mode,
as the JAX suite runs it here) and through the port's wrapper, which on CPU
tensors takes the kernel's plain PyTorch version. Bars are the JAX suite's:
2e-5 at float32 (tests/test_flash_attention.py, tests/test_paged_decode.py)
and 3e-2 at bfloat16 (tests/test_flash_attention.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_common as jax_dc
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import MappingConfig as JaxMapping
from repro.kernels.flash_attention import flash_attention_fwd as jax_fa
from repro.kernels.paged_decode_attention import paged_flash_decode as jax_decode
from repro.kernels.paged_prefill_attention import paged_flash_prefill as jax_prefill
from tc_decode_emulation import softcap_log2

from repro_torch.kernels import decode_common, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.paged_decode_attention import paged_flash_decode
from repro_torch.kernels.paged_prefill_attention import paged_flash_prefill

F32_TOL = 2e-5
BF16_TOL = 3e-2
HEADS = [(4, 2), (4, 4), (4, 1)]          # GQA, MHA, MQA
HEAD_IDS = ["gqa", "mha", "mqa"]


def _pair(a: np.ndarray, dtype="float32"):
    """The same values as a JAX array and a torch tensor."""
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _diff(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- K1 ------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)],
                         ids=["full", "window_softcap"])
def test_flash_fwd_matches_jax(hq, hkv, window, softcap):
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, 2, h, 64, 32) for h in (hq, hkv, hkv))
    (qj, qt), (kj, kt), (vj, vt) = _pair(q), _pair(k), _pair(v)
    oj, lj = jax_fa(qj, kj, vj, mapping=JaxMapping(block_m=32, block_n=32),
                    causal=True, window=window, softcap=softcap, interpret=True)
    ot, lt = flash_attention_fwd(qt, kt, vt, causal=True, window=window,
                                 softcap=softcap)
    assert _diff(oj, ot) < F32_TOL
    assert _diff(lj, lt) < F32_TOL
    lse = jax_ref.attention_lse(qj, kj, vj, causal=True, window=window,
                                softcap=softcap)
    assert _diff(lse, lt) < F32_TOL


def test_flash_fwd_kv_len_padding_and_noncausal():
    """Padded keys past ``kv_len`` are masked; non-causal attention."""
    rng = np.random.default_rng(1)
    q, k, v = _normal(rng, 1, 4, 32, 16), _normal(rng, 1, 2, 64, 16), _normal(rng, 1, 2, 64, 16)
    (qj, qt), (kj, kt), (vj, vt) = _pair(q), _pair(k), _pair(v)
    oj, lj = jax_fa(qj, kj, vj, mapping=JaxMapping(block_m=32, block_n=32),
                    causal=False, kv_len=50, interpret=True)
    ot, lt = flash_attention_fwd(qt, kt, vt, causal=False, kv_len=50)
    assert _diff(oj, ot) < F32_TOL
    assert _diff(lj, lt) < F32_TOL


def test_flash_fwd_bf16_matches_jax():
    rng = np.random.default_rng(2)
    q, k, v = _normal(rng, 1, 4, 64, 32), _normal(rng, 1, 2, 64, 32), _normal(rng, 1, 2, 64, 32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (q, k, v))
    oj, _ = jax_fa(qj, kj, vj, mapping=JaxMapping(block_m=32, block_n=32),
                   causal=True, interpret=True)
    ot, _ = flash_attention_fwd(qt, kt, vt, causal=True)
    assert ot.dtype == torch.bfloat16
    assert _diff(oj, ot) < BF16_TOL


def test_plain_k1_k5_k6_by_blocks_match_jax(monkeypatch):
    """Past ``ref.PLAIN_SCORE_ELEMS`` scores the plain versions of K1 and
    K5 / K6 run one batch row and a few kv heads at a time (a 6144-token
    prefill at Hq 32 would hold ~20 GB at once). Here the limit is cut so
    that blocks of 2 of 3 kv heads cover B 2, Hq 12: o and lse against the
    JAX reference (window and softcap), the gradients against the whole
    call's (kv_len masking too)."""
    from repro_torch.kernels import flash_attention_bwd as fb

    rng = np.random.default_rng(3)
    q, do = _normal(rng, 2, 12, 40, 16), _normal(rng, 2, 12, 40, 16)
    k, v = _normal(rng, 2, 3, 40, 16), _normal(rng, 2, 3, 40, 16)
    (qj, qt), (kj, kt), (vj, vt) = _pair(q), _pair(k), _pair(v)
    dot = torch.from_numpy(do)
    kw = dict(causal=True, window=13, softcap=20.0)
    whole = fb.flash_attention_bwd_plain(qt, kt, vt, *flash_attention_fwd(qt, kt, vt, **kw),
                                         dot, kv_len=33, **kw)
    monkeypatch.setattr(ref, "PLAIN_SCORE_ELEMS", 2 * 4 * 40 * 40)
    assert ref.score_blocks(2, 3, 4, 40, 40) == [(0, 0, 2), (0, 2, 3), (1, 0, 2), (1, 2, 3)]
    ot, lt = flash_attention_fwd(qt, kt, vt, **kw)
    assert _diff(jax_ref.attention(qj, kj, vj, **kw), ot) < F32_TOL
    assert _diff(jax_ref.attention_lse(qj, kj, vj, **kw), lt) < F32_TOL
    blocked = fb.flash_attention_bwd_plain(qt, kt, vt, ot, lt, dot, kv_len=33, **kw)
    assert max(_diff(a.numpy(), b) for a, b in zip(whole, blocked)) < F32_TOL


ROW_TOL = 2.0**-6   # per row, against the row's max |o|: one bf16 ulp is 2^-7
LSE_TOL = 1e-5


def _tensor_core_k1(q, k, v, *, causal, window=None, softcap=None, kv_len=None,
                    q_offset=None, block_n=128):
    """The arithmetic of K1's bf16 tensor-core kernel (``fa2_fwd_tc`` in
    csrc/flash_attention.cu), written out in float32: products of bf16
    inputs summed in float32; scores in log2 units with scale * log2(e)
    folded into one multiply (a softcap first: ``softcap_log2``); an online
    softmax over 128-key tiles with exp2; P rounded to bf16 before P V while
    the row sum takes P unrounded; float32 accumulation; o rounded to bf16,
    lse = m ln 2 + log l. ``q_offset`` / ``kv_len`` (ints or (B,) tensors)
    walk as the kernel's per-row arrays: query row i of batch row b at
    position q_offset[b] + i, keys at or past kv_len[b] masked; each block
    walks only the ``block_n``-key tiles its rows can see (``kv_tile_range``
    of csrc/common.cuh at the shifted rows), 128 query rows a block. The
    kernel's key tile is 128, and 64 at head_dim 256."""
    log2e, ln2 = 1.4426950408889634, 0.6931471805599453
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    per_row = lambda x, default: (x.long() if isinstance(x, torch.Tensor)
                                  else torch.full((b,), default if x is None else x))
    live = torch.clamp(per_row(kv_len, skv), max=skv)[:, None, None, None]
    off = per_row(q_offset, 0)[:, None, None, None]
    group = hq // k.shape[1]
    qf = q.float()
    kf, vf = k.float().repeat_interleave(group, 1), v.float().repeat_interleave(group, 1)
    scale = 1.0 / d**0.5
    rows = off + torch.arange(sq)[:, None]                       # (B, 1, Sq, 1)
    # The tiles [n_lo, n_hi) each 128-row block walks, per (b, row).
    q0 = off + torch.arange(sq)[:, None] // 128 * 128
    n_hi = -(-live // block_n)
    if causal:
        n_hi = torch.minimum(n_hi, (q0 + 128 + block_n - 1) // block_n)
    n_lo = torch.clamp(q0 - window + 1, min=0) // block_n if window else torch.zeros_like(q0)
    m = torch.full((b, hq, sq), -1e30)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for c0 in range(0, skv, block_n):
        walked = ((c0 // block_n >= n_lo) & (c0 // block_n < n_hi))[..., 0]   # (B, 1, Sq)
        s = qf @ kf[:, :, c0:c0 + block_n].transpose(-1, -2)
        if softcap:
            x = softcap_log2(s, scale, softcap)
        else:
            x = s * torch.tensor(scale * log2e, dtype=torch.float32)
        cols = torch.arange(c0, c0 + s.shape[-1])[None, :]
        ok = cols < live
        if causal:
            ok = ok & (cols <= rows)
        if window:
            ok = ok & (cols > rows - window)
        x = torch.where(ok, x, torch.tensor(-1e30))
        m_new = torch.where(walked, torch.maximum(m, x.amax(-1)), m)
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok & walked[..., None], torch.exp2(x - m_new[..., None]),
                        torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, c0:c0 + block_n]
        m = m_new
    o = (acc / torch.where(l == 0, 1.0, l)[..., None]).to(torch.bfloat16)
    lse = torch.where(l == 0, torch.tensor(-1e30), m * ln2 + torch.log(l))
    return o, lse


def _row_err(j, t) -> float:
    """Max over rows of max |t - j| / max |j| (an all-zero row of j must be
    exactly zero in t)."""
    ref = torch.from_numpy(np.asarray(j, np.float32))
    diff = (t.float() - ref).abs().amax(-1)
    den = ref.abs().amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=50, softcap=30.0),
                                dict(causal=False, kv_len=101)],
                         ids=["causal", "window_softcap", "noncausal_kvlen"])
def test_tensor_core_k1_arithmetic_matches_jax(d, kw):
    """Rounding P to bf16 before P V, the tensor-core K1's one numerical
    departure from the JAX kernel (which keeps P in float32), stays within
    the card's bars: o per row within 2^-6, lse within 1e-5. Hq 8 over Hkv 2,
    S 130 (one full 128-key tile and a ragged one; at head_dim 256 two full
    64-key tiles and a ragged one)."""
    rng = np.random.default_rng(60 + d)
    q, k, v = _normal(rng, 1, 8, 130, d), _normal(rng, 1, 2, 130, d), _normal(rng, 1, 2, 130, d)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (q, k, v))
    oj, lj = jax_fa(qj, kj, vj, mapping=JaxMapping(block_m=256, block_n=256),
                    interpret=True, **kw)
    block_n = 64 if d == 256 else 128
    ot, lt = _tensor_core_k1(qt, kt, vt, block_n=block_n, **kw)
    assert _row_err(oj, ot) < ROW_TOL
    assert _diff(lj, lt) < LSE_TOL
    if kw.get("kv_len"):            # keys past kv_len change nothing
        ot2, _ = _tensor_core_k1(qt, kt, torch.where(torch.arange(130)[:, None] < 101, vt,
                                                     torch.tensor(7.0, dtype=vt.dtype)),
                                 block_n=block_n, **kw)
        assert torch.equal(ot, ot2)


def test_softcap_log2_matches_tanh_and_saturates():
    """The consumers' softcap (one ex2, one rcp) against softcap * tanh *
    log2(e): within 2e-6 of the cap over |y| <= 8, and exactly +-cap * log2(e)
    past |y| 44, where the power is inf or 0 (no NaN)."""
    scale, cap = 0.0625, 30.0
    y = torch.cat([torch.linspace(-8.0, 8.0, 4001), torch.tensor([-1e4, -90.0, -45.0, 45.0,
                                                                  90.0, 1e4])])
    s = (y * cap / scale).float()
    got = softcap_log2(s, scale, cap)
    want = cap * torch.tanh(y.double()) * 1.4426950408889634
    assert torch.isfinite(got).all()
    assert float((got.double() - want).abs().max()) < 2e-6 * cap
    c = torch.tensor(cap, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                               dtype=torch.float32)
    assert torch.equal(got[-6:], torch.stack([-c, -c, -c, c, c, c]))


@pytest.mark.parametrize("d", [64, 256])
def test_tensor_core_k1_saturated_softcap_matches_jax(d):
    """Scores far past the softcap (q x 100, k x 20, softcap 5: |s scale /
    cap| mostly beyond 44, where the kernel's power overflows to inf or
    flushes to 0) give the JAX kernel's tanh, causal, window 50: o per row
    within 2^-6, lse within 1e-5."""
    rng = np.random.default_rng(64 + d)
    q, k, v = (_normal(rng, 1, h, 130, d) for h in (4, 2, 2))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (100 * q, 20 * k, v))
    kw = dict(causal=True, window=50, softcap=5.0)
    oj, lj = jax_fa(qj, kj, vj, mapping=JaxMapping(block_m=256, block_n=256),
                    interpret=True, **kw)
    ot, lt = _tensor_core_k1(qt, kt, vt, block_n=64 if d == 256 else 128, **kw)
    assert _row_err(oj, ot) < ROW_TOL
    assert _diff(lj, lt) < LSE_TOL


@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("window,softcap", [(None, None), (90, 30.0)],
                         ids=["causal", "window_softcap"])
def test_tensor_core_k1_offset_walk_matches_jax(hq, hkv, window, softcap):
    """The tensor-core K1's walk under per-row query offsets, written out in
    float32, against JAX's ``ref.attention(q_offset=)`` row by row: three
    rows of 140 queries at offsets 0, 37 and 250 over 400 keys, each with
    its own kv_len (the second stops 5 keys short of its last query). Rows
    within 2^-6 of their max, lse within 1e-5."""
    rng = np.random.default_rng(70 + hq + hkv)
    d, sq, skv = 64, 140, 400
    q, k, v = (_normal(rng, 3, h, n, d) for h, n in ((hq, sq), (hkv, skv), (hkv, skv)))
    off, kv_len = [0, 37, 250], [sq, 37 + sq - 5, 250 + sq]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (q, k, v))
    ot, lt = _tensor_core_k1(qt, kt, vt, causal=True, window=window, softcap=softcap,
                             q_offset=torch.tensor(off), kv_len=torch.tensor(kv_len))
    for i, (o_i, n) in enumerate(zip(off, kv_len)):
        args = (qj[i:i + 1], kj[i:i + 1, :, :n], vj[i:i + 1, :, :n])
        kw = dict(causal=True, window=window, softcap=softcap, q_offset=o_i)
        assert _row_err(jax_ref.attention(*args, **kw), ot[i:i + 1]) < ROW_TOL
        assert _diff(jax_ref.attention_lse(*args, **kw), lt[i:i + 1]) < LSE_TOL


def test_ops_flash_attention_pads_and_matches_ref():
    """The ops entry point (odd lengths, plan-resolved impl) equals the
    JAX oracle."""
    rng = np.random.default_rng(3)
    q, k, v = _normal(rng, 2, 4, 37, 16), _normal(rng, 2, 2, 37, 16), _normal(rng, 2, 2, 37, 16)
    (qj, qt), (kj, kt), (vj, vt) = _pair(q), _pair(k), _pair(v)
    want = jax_ref.attention(qj, kj, vj, causal=True)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert got.shape == qt.shape
    assert _diff(want, got) < F32_TOL


# -- K2 ------------------------------------------------------------------------


def _paged_prefill_inputs(rng, hq, hkv, d=32, ps=16, st=24, mp=4, num_pages=20):
    b = 2
    q = _normal(rng, b, hq, st, d)
    kt, vt = _normal(rng, b, hkv, st, d), _normal(rng, b, hkv, st, d)
    kp, vp = _normal(rng, hkv, num_pages, ps, d), _normal(rng, hkv, num_pages, ps, d)
    table = np.stack([rng.permutation(np.arange(1, num_pages))[:mp] for _ in range(b)])
    plen = np.array([mp * ps - 7, 17], np.int32)        # not page multiples
    tlen = np.array([st, 9], np.int32)                  # second tail padded
    return q, kp, vp, table.astype(np.int32), kt, vt, plen, tlen


@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("window,softcap", [(None, None), (20, 30.0)],
                         ids=["full", "window_softcap"])
def test_paged_prefill_matches_jax(hq, hkv, window, softcap):
    rng = np.random.default_rng(10)
    args = _paged_prefill_inputs(rng, hq, hkv)
    jargs, targs = zip(*(_pair(a) for a in args))
    oj = jax_prefill(*jargs, window=window, softcap=softcap, interpret=True)
    ot = paged_flash_prefill(*targs, window=window, softcap=softcap)
    assert _diff(oj, ot) < F32_TOL
    # Rows at or past tail_len are exact zeros.
    assert float(ot[1, :, 9:].abs().max()) == 0.0
    want = jax_ref.paged_prefill_attention(*jargs, window=window, softcap=softcap)
    assert _diff(want, ref.paged_prefill_attention(*targs, window=window,
                                                   softcap=softcap)) < F32_TOL


def test_paged_prefill_empty_table_matches_jax():
    """A prefix table of width 0: only the causal tail is attended."""
    rng = np.random.default_rng(11)
    q, kp, vp, _, kt, vt, _, tlen = _paged_prefill_inputs(rng, 4, 2)
    table = np.zeros((2, 0), np.int32)
    plen = np.zeros((2,), np.int32)
    args = (q, kp, vp, table, kt, vt, plen, tlen)
    jargs, targs = zip(*(_pair(a) for a in args))
    oj = jax_prefill(*jargs, interpret=True)
    ot = paged_flash_prefill(*targs)
    assert _diff(oj, ot) < F32_TOL


def test_paged_prefill_bf16_matches_jax():
    rng = np.random.default_rng(12)
    args = _paged_prefill_inputs(rng, 4, 2)
    conv = [_pair(a, "bfloat16") if a.dtype == np.float32 else _pair(a) for a in args]
    jargs, targs = zip(*conv)
    oj = jax_prefill(*jargs, interpret=True)
    ot = paged_flash_prefill(*targs)
    assert _diff(oj, ot) < BF16_TOL


# -- K3 / K4 -------------------------------------------------------------------


def _paged_decode_inputs(rng, hq, hkv, d=32, ps=16, mp=6, b=4):
    num_pages = 1 + b * mp
    q = _normal(rng, b, hq, d)
    kp, vp = _normal(rng, hkv, num_pages, ps, d), _normal(rng, hkv, num_pages, ps, d)
    perm = rng.permutation(np.arange(1, num_pages))
    table = perm.reshape(b, mp).astype(np.int32)
    lengths = np.array([0, 1, 50, mp * ps], np.int32)[:b]   # one length-0 row
    return q, kp, vp, table, lengths


#: (hq, hkv, num_splits, case): every head layout at 1, 2 and 7 splits on
#: ``_paged_decode_inputs``; and mixtral's case, group 4 at D 128 under a
#: window that leaves whole splits before its first key.
DECODE_CASES = [pytest.param(hq, hkv, ns, None, id=f"{hid}-{ns}")
                for (hq, hkv), hid in zip(HEADS, HEAD_IDS) for ns in (1, 2, 7)] + [
    pytest.param(8, 2, 9, "window_empties_splits", id="d128_group4_window_empties_splits-9")]


def _windowed_decode_inputs(rng):
    """D 128, pages of 16, 18-page tables (9 splits of 2 pages): a row of
    288 tokens under window 100 (keys 188 .. 287: splits 0-4 hold no live
    key), one of 250 (splits 0-3 empty) and one frozen at length 0."""
    q, kp, vp, table, _ = _paged_decode_inputs(rng, 8, 2, d=128, ps=16, mp=18, b=3)
    return q, kp, vp, table, np.array([288, 0, 250], np.int32)


@pytest.mark.parametrize("hq,hkv,num_splits,case", DECODE_CASES)
def test_paged_decode_matches_jax(hq, hkv, num_splits, case):
    rng = np.random.default_rng(20 + num_splits)
    if case is None:
        window, softcap = ((None, None) if hkv == 2 else (24, 30.0))
        args = _paged_decode_inputs(rng, hq, hkv)
    else:
        window, softcap = 100, None
        args = _windowed_decode_inputs(rng)
    jargs, targs = zip(*(_pair(a) for a in args))
    oj = jax_decode(*jargs, num_splits=num_splits, window=window, softcap=softcap,
                    interpret=True)
    ot = paged_flash_decode(*targs, num_splits=num_splits, window=window,
                            softcap=softcap)
    assert _diff(oj, ot) < F32_TOL
    zero_row = 0 if case is None else 1
    assert float(ot[zero_row].abs().max()) == 0.0    # length-0 row: exact zeros
    want = jax_ref.split_decode_attention(
        jargs[0], jax_ref.gather_pages(jargs[1], jargs[3]),
        jax_ref.gather_pages(jargs[2], jargs[3]), jargs[4],
        num_splits=num_splits, granule=16, window=window, softcap=softcap)
    got = ref.split_decode_attention(
        targs[0], ref.gather_pages(targs[1], targs[3]), ref.gather_pages(targs[2], targs[3]),
        targs[4], num_splits=num_splits, granule=16, window=window, softcap=softcap)
    assert _diff(want, got) < F32_TOL


def test_paged_decode_bf16_matches_jax():
    rng = np.random.default_rng(30)
    args = _paged_decode_inputs(rng, 4, 2)
    conv = [_pair(a, "bfloat16") if a.dtype == np.float32 else _pair(a) for a in args]
    jargs, targs = zip(*conv)
    oj = jax_decode(*jargs, num_splits=2, interpret=True)
    ot = paged_flash_decode(*targs, num_splits=2)
    assert _diff(oj, ot) < BF16_TOL


def test_paged_decode_rejects_quantized_pools():
    """A quantized pool needs both scale tables: one alone raises."""
    rng = np.random.default_rng(31)
    _, targs = zip(*(_pair(a) for a in _paged_decode_inputs(rng, 4, 2)))
    with pytest.raises(ValueError, match="together"):
        paged_flash_decode(*targs, k_scales=torch.ones(2, 25))


# -- decode_common pieces ------------------------------------------------------


def test_combine_split_states_matches_jax():
    """Including all-empty rows (every split NEG_INF, l == 0)."""
    rng = np.random.default_rng(40)
    acc = _normal(rng, 3, 2, 5, 4, 8)
    m = _normal(rng, 3, 2, 5, 4, 1)
    l = np.abs(_normal(rng, 3, 2, 5, 4, 1))
    m[0, 0, 1:] = -1e30          # splits that saw no relevant KV
    l[0, 0, 1:] = 0.0
    acc[0, 0, 1:] = 0.0
    m[1, 1] = -1e30              # a row with no live split
    l[1, 1] = 0.0
    acc[1, 1] = 0.0
    want = jax_dc.combine_split_states(*(jnp.asarray(a) for a in (acc, m, l)))
    got = decode_common.combine_split_states(*(torch.from_numpy(a) for a in (acc, m, l)))
    assert _diff(want, got) < F32_TOL
    assert float(got[1, 1].abs().max()) == 0.0


def test_chunk_relevant_matches_jax():
    for window in (None, 0, 1, 7, 16, 40):
        for length in range(0, 70, 3):
            for start in range(0, 80, 16):
                want = bool(jax_dc.chunk_relevant(start, 16, length, window))
                assert decode_common.chunk_relevant(start, 16, length, window) == want


def test_accumulate_kv_block_matches_jax_ref():
    """Two online steps over two units equal the exact decode oracle."""
    rng = np.random.default_rng(41)
    q = _normal(rng, 3, 4, 16)
    k, v = _normal(rng, 3, 32, 16), _normal(rng, 3, 32, 16)
    length = np.array([0, 20, 32], np.int64)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    ln = torch.from_numpy(length)
    acc = torch.zeros(3, 4, 16)
    m = torch.full((3, 4, 1), -1e30)
    l = torch.zeros(3, 4, 1)
    for start in (0, 16):
        acc, m, l = decode_common.accumulate_kv_block(
            qt, kt[:, start:start + 16], vt[:, start:start + 16], acc, m, l,
            scale=0.25, softcap=None, window=None, block_start=start, length=ln)
    got = acc / torch.where(l == 0, 1.0, l)
    want = jax_ref.decode_attention(
        jnp.asarray(q), jnp.asarray(k)[:, None], jnp.asarray(v)[:, None],
        jnp.asarray(length.astype(np.int32)), scale=0.25)
    assert _diff(want, got) < F32_TOL


@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
def test_ref_oracles_match_jax(hq, hkv):
    rng = np.random.default_rng(50)
    q, k, v = _normal(rng, 2, hq, 12, 16), _normal(rng, 2, hkv, 12, 16), _normal(rng, 2, hkv, 12, 16)
    (qj, qt), (kj, kt), (vj, vt) = _pair(q), _pair(k), _pair(v)
    for kw in (dict(causal=True), dict(causal=True, window=5, softcap=20.0),
               dict(causal=False)):
        assert _diff(jax_ref.attention(qj, kj, vj, **kw), ref.attention(qt, kt, vt, **kw)) < F32_TOL
        assert _diff(jax_ref.attention_lse(qj, kj, vj, **kw),
                     ref.attention_lse(qt, kt, vt, **kw)) < F32_TOL
    qd = _normal(rng, 2, hq, 16)
    lengths = np.array([0, 9], np.int32)
    (qdj, qdt), (lj, lt) = _pair(qd), _pair(lengths)
    assert _diff(jax_ref.decode_attention(qdj, kj, vj, lj, window=4),
                 ref.decode_attention(qdt, kt, vt, lt, window=4)) < F32_TOL
