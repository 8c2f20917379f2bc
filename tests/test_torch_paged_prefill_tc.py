"""K2's bf16 tensor-core arithmetic against the JAX package, on the CPU.

``paged_prefill_tc_kernel`` (csrc/paged_prefill.cu, on the consumer of
csrc/prefill_tc.cuh) runs no CPU mode, so its arithmetic is written out
here in float32 (``_tensor_core_k2``): per 128-row tile of one (b, q head),
products of bf16 inputs summed in float32; scores in log2 units with
scale * log2(e) folded into one multiply (a softcap first, as the kernel's
one ex2 and one rcp: ``tc_decode_emulation.softcap_log2``);
an online softmax with exp2 over 128-key tiles (64-key at head_dim 256),
the prefix's first, page by
page from the page holding the tile's first visible position (a stage's
slots past the last live page repeat it, masked), then the tail's; P
rounded to bf16 before P V while the row sum takes P unrounded; rows at or
past tail_len, and row tiles with no live row, give zeros. It is held
against ``repro.kernels.paged_prefill_attention.paged_flash_prefill`` in
interpret mode on scattered page tables: per row within 2^-6 of the row's
max |o| (one bf16 ulp is 2^-7; the card's bar) and within the JAX suite's
bf16 bar of 3e-2.

K2q (``paged_prefill_q_tc_kernel``: bf16 q over int8 or fp8 prefix codes)
feeds that same consumer bf16 stages in which each code is
bf16(float32(code) x its page's scale) and every position at or past the
live prefix is 0 by select; ``_tensor_core_k2q`` writes that out and runs
``_tensor_core_k2`` on it, held at the same bars against the JAX kernel's
scale branch on pools the JAX package quantized, at head_dim 256 (gemma2's
group of 2, softcap 50) too, where the stages hold 64 keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import quant as jax_quant
from repro.kernels.paged_prefill_attention import paged_flash_prefill as jax_prefill
from tc_decode_emulation import softcap_log2

ROW_TOL = 2.0**-6
BF16_TOL = 3e-2
BLOCK = 128                     # query rows of a tile, and its keys below head_dim 256
ST = 150                        # two row tiles, the second of 22 rows
TLEN = [ST, 100]                # the second row's tail padded past 100
TABLE = {8: 25, 16: 13, 32: 7}  # pages a row: ~200 positions, no multiple of 128 / ps
LOG2E, NEG_INF = 1.4426950408889634, -1e30


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops gain nothing from intra-op threads, and under pytest-xdist
    those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensor_core_k2(q, kp, vp, table, kt, vt, plen, tlen, *, window=None, softcap=None):
    """The arithmetic of ``paged_prefill_tc`` in float32 (module docstring);
    bf16 in, bf16 out, the JAX function's arguments."""
    b, hq, st, d = q.shape
    hkv, _, ps, _ = kp.shape
    group, mp = hq // hkv, table.shape[1]
    bn = 64 if d == 256 else BLOCK          # keys of a stage
    per_stage = bn // ps
    scale2 = torch.tensor(LOG2E / d**0.5, dtype=torch.float32)
    expand = lambda x: x.float().repeat_interleave(group, 0)      # (Hkv, n, D) -> (Hq, n, D)
    o = torch.zeros((b, hq, st, d))
    for bi in range(b):
        pl, tl = int(plen[bi]), int(tlen[bi])
        live = min(pl, mp * ps)
        for q0 in range(0, st, BLOCK):
            q_hi = min(q0 + BLOCK, tl, st) - 1
            if q_hi < q0:
                continue                       # no live row: the tile stores zeros
            rows = torch.arange(q0, min(q0 + BLOCK, st))[:, None]
            qf = q[bi, :, q0:q0 + BLOCK].float()
            tiles = []                         # (K, V, columns, mask) of each tile in order
            lo = max(0, pl + q0 - window + 1) if window else 0
            if lo < live:
                first, last = lo // ps, (live - 1) // ps
                for t in range((last - first + per_stage) // per_stage):
                    pages = [int(table[bi, min(first + t * per_stage + i, last)])
                             for i in range(per_stage)]
                    cols = first * ps + t * bn + torch.arange(bn)[None, :]
                    ok = (rows < tl) & (cols < live)
                    if window:
                        ok = ok & (cols > pl + rows - window)
                    tiles.append((kp[:, pages].reshape(hkv, bn, d),
                                  vp[:, pages].reshape(hkv, bn, d), ok))
            tail_lo = max(0, q0 - window + 1) // bn if window else 0
            for n in range(tail_lo, q_hi // bn + 1):
                c0 = n * bn
                pad = lambda x: torch.nn.functional.pad(x[bi, :, c0:c0 + bn],
                                                        (0, 0, 0, bn - min(bn, st - c0)))
                cols = c0 + torch.arange(bn)[None, :]
                ok = (rows < tl) & (cols <= rows)
                if window:
                    ok = ok & (cols > rows - window)
                tiles.append((pad(kt), pad(vt), ok))
            m = torch.full((hq, qf.shape[1]), NEG_INF)
            l = torch.zeros((hq, qf.shape[1]))
            acc = torch.zeros((hq, qf.shape[1], d))
            for k, v, ok in tiles:
                s = qf @ expand(k).transpose(-1, -2)
                x = softcap_log2(s, 1.0 / d**0.5, softcap) if softcap else s * scale2
                x = torch.where(ok, x, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.where(ok, torch.exp2(x - m_new[..., None]), torch.tensor(0.0))
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ expand(v)
                m = m_new
            o[bi, :, q0:q0 + BLOCK] = acc / torch.where(l == 0, 1.0, l)[..., None]
    return o.to(torch.bfloat16)


def _inputs(hq, hkv, d, ps, seed, empty_table=False):
    """bf16 q, pools (Hkv, P, ps, D) and tail K/V, a scattered page table
    (page 0 is the null page, never in a table); the first row's prefix is
    no page multiple, the second's 37 positions on a full-width table."""
    rng = np.random.default_rng(seed)
    b, mp = 2, 0 if empty_table else TABLE[ps]
    num_pages = 1 + b * TABLE[ps]
    shapes = ((b, hq, ST, d), (hkv, num_pages, ps, d), (hkv, num_pages, ps, d),
              (b, hkv, ST, d), (b, hkv, ST, d))
    q, kp, vp, kt, vt = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    table = rng.permutation(np.arange(1, num_pages))[: b * mp].reshape(b, mp).astype(np.int32)
    plen = np.asarray([0, 0] if empty_table else [mp * ps - 5, 37], np.int32)
    tlen = np.asarray(TLEN, np.int32)
    arrays = (q, kp, vp, table, kt, vt, plen, tlen)
    jax_args = [jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32 else jnp.asarray(a)
                for a in arrays]
    torch_args = [torch.from_numpy(a).to(torch.bfloat16) if a.dtype == np.float32
                  else torch.from_numpy(a) for a in arrays]
    return jax_args, torch_args


def _row_err(j, t) -> float:
    """Max over rows of max |t - j| / max |j| (an all-zero row of j must be
    exactly zero in t)."""
    ref = torch.from_numpy(np.asarray(j, np.float32))
    diff = (t.float() - ref).abs().amax(-1)
    den = ref.abs().amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


def _check(jargs, targs, **kw):
    oj = jax_prefill(*jargs, interpret=True, **kw)
    ot = _tensor_core_k2(*targs, **kw)
    assert _row_err(oj, ot) < ROW_TOL
    assert float(np.abs(np.asarray(oj, np.float32) - ot.float().numpy()).max()) < BF16_TOL
    for bi, t in enumerate(TLEN):            # rows at or past tail_len
        assert float(ot[bi, :, t:].float().abs().sum()) == 0.0
    return ot


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("hq,hkv,window,softcap", [(8, 2, None, None), (2, 2, 70, 30.0)],
                         ids=["g4", "g1_window_softcap"])
def test_tensor_core_k2_arithmetic_matches_jax(d, ps, hq, hkv, window, softcap):
    """Tables of 25, 13 and 7 pages leave the last prefix stage part-filled
    (its surplus slots repeat the last live page, masked); the first row's
    prefix ends 5 positions into its last page. With window 70 the first
    row tile's walk starts at a page inside the prefix and the second row
    tile's skips the prefix. Positions past each prefix inside its last live
    page change nothing: filled with +-1e4 they give the same bits."""
    jargs, targs = _inputs(hq, hkv, d, ps, seed=100 + d + ps)
    kw = dict(window=window, softcap=softcap)
    ot = _check(jargs, targs, **kw)
    q, kp, vp, table, kt, vt, plen, tlen = targs
    kp2, vp2 = kp.clone(), vp.clone()
    big = torch.tensor(1e4, dtype=torch.bfloat16)
    for bi, n in enumerate(plen.tolist()):
        if n % ps:
            page = int(table[bi, n // ps])
            kp2[:, page, n % ps:] = big
            vp2[:, page, n % ps:] = -big
    assert not torch.equal(kp, kp2)
    assert torch.equal(ot, _tensor_core_k2(q, kp2, vp2, table, kt, vt, plen, tlen, **kw))


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tensor_core_k2_empty_table_matches_jax(d):
    """A table of width 0: only the causal tail is walked."""
    jargs, targs = _inputs(8, 2, d, 16, seed=110 + d, empty_table=True)
    _check(jargs, targs)


# -- K2q: quantized prefix codes -------------------------------------------------


def _tensor_core_k2q(q, kc, vc, ks, vs, table, kt, vt, plen, tlen, **kw):
    """The arithmetic of ``paged_prefill_q_tc``: each code widened and
    multiplied by its page's scale in float32, rounded once to bf16, every
    position at or past the row's live prefix 0 (by select: a row's last
    live page is its own), then ``_tensor_core_k2`` as it stands."""
    ps, mp = kc.shape[2], table.shape[1]
    kd = (kc.float() * ks[..., None, None]).to(torch.bfloat16)
    vd = (vc.float() * vs[..., None, None]).to(torch.bfloat16)
    outs = []
    for bi in range(q.shape[0]):
        live = min(int(plen[bi]), mp * ps)
        kp, vp = kd.clone(), vd.clone()
        for j, pid in enumerate(table[bi].tolist()):
            start = max(0, live - j * ps)
            if start < ps:
                kp[:, pid, start:] = 0
                vp[:, pid, start:] = 0
        row = slice(bi, bi + 1)
        outs.append(_tensor_core_k2(q[row], kp, vp, table[row], kt[row], vt[row], plen[row],
                                    tlen[row], **kw))
    return torch.cat(outs)


def _quantized_inputs(hq, hkv, d, ps, kv_dtype, seed):
    """bf16 q and tail; K / V pools quantized by the JAX package (codes and
    (Hkv, P) scales carried across as numpy); a scattered table. Row 0's
    prefix is no page multiple; row 1's is 1 position on a table padded with
    the null page 0, with a tail of 1 row. The null page holds what rows
    frozen on it leave: codes 0x7F (NaN bits in e4m3) and NaN scales."""
    rng = np.random.default_rng(seed)
    b, mp = 2, TABLE[ps]
    num_pages = 2 + mp
    q = rng.standard_normal((b, hq, ST, d)).astype(np.float32)
    kt, vt = (rng.standard_normal((b, hkv, ST, d)).astype(np.float32) for _ in range(2))
    codes, scales = [], []
    for _ in range(2):
        c, sc = jax_quant.quantize_pages(
            jnp.asarray(rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)),
            kv_dtype)
        c, sc = np.array(c), np.array(sc)
        c.view(np.uint8)[:, 0] = 0x7F
        sc[:, 0] = np.nan
        codes.append(c)
        scales.append(sc)
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((b, mp), np.int32)
    table[0] = perm[:mp]
    table[1, 0] = perm[mp]
    plen = np.asarray([mp * ps - 5, 1], np.int32)
    tlen = np.asarray([ST, 1], np.int32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    jax_args = (bf(q), jnp.asarray(codes[0]), jnp.asarray(codes[1]), jnp.asarray(table), bf(kt),
                bf(vt), jnp.asarray(plen), jnp.asarray(tlen))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tcodes = [torch.from_numpy(c.view(np.uint8)).view(torch.float8_e4m3fn)
              if kv_dtype == "fp8" else torch.from_numpy(c) for c in codes]
    torch_args = (tb(q), *tcodes, torch.from_numpy(scales[0]), torch.from_numpy(scales[1]),
                  torch.from_numpy(table), tb(kt), tb(vt), torch.from_numpy(plen),
                  torch.from_numpy(tlen))
    return jax_args, (jnp.asarray(scales[0]), jnp.asarray(scales[1])), torch_args


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("d,ps,hq,hkv,window,softcap",
                         [(64, 8, 8, 2, None, None), (128, 16, 10, 2, 50, 30.0),
                          (256, 16, 8, 4, 50, 50.0)],
                         ids=["d64_ps8_g4", "d128_ps16_g5_window_softcap",
                              "d256_ps16_gemma2_window_softcap"])
def test_tensor_core_k2q_arithmetic_matches_jax(kv_dtype, d, ps, hq, hkv, window, softcap):
    """K2q's arithmetic against the JAX kernel's scale branch (float32
    dequantization) per row within 2^-6 and within 3e-2; rows past
    tail_len exactly zero. Row 1 sees one prefix position and its one tail
    row. Codes 0x7F past each prefix inside its last live page change no
    bit: those positions are 0 by select, and the null page (NaN scales and
    codes) is never read."""
    jargs, (jks, jvs), targs = _quantized_inputs(hq, hkv, d, ps, kv_dtype, seed=120 + d + ps)
    kw = dict(window=window, softcap=softcap)
    oj = jax_prefill(*jargs, k_scales=jks, v_scales=jvs, interpret=True, **kw)
    ot = _tensor_core_k2q(*targs, **kw)
    assert _row_err(oj, ot) < ROW_TOL
    assert float(np.abs(np.asarray(oj, np.float32) - ot.float().numpy()).max()) < BF16_TOL
    q, kc, vc, ks, vs, table, kt, vt, plen, tlen = targs
    for bi, t in enumerate(tlen.tolist()):
        assert float(ot[bi, :, t:].float().abs().sum()) == 0.0
    k2, v2 = kc.clone(), vc.clone()
    ps = kc.shape[2]
    for bi, n in enumerate(plen.tolist()):
        page = int(table[bi, n // ps])
        for codes in (k2, v2):
            codes.view(torch.uint8)[:, page, n % ps:] = 0x7F
    assert not torch.equal(kc.view(torch.uint8), k2.view(torch.uint8))
    assert torch.equal(ot, _tensor_core_k2q(q, k2, v2, ks, vs, table, kt, vt, plen, tlen, **kw))

