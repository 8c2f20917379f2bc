"""K2's bf16 tensor-core arithmetic against the JAX package, on the CPU.

``paged_prefill_tc_kernel`` (csrc/paged_prefill.cu, on the consumer of
csrc/prefill_tc.cuh) runs no CPU mode, so its arithmetic is written out
here in float32 (``_tensor_core_k2``): per 128-row tile of one (b, q head),
products of bf16 inputs summed in float32; scores in log2 units with
scale * log2(e) folded into one multiply (softcap first, in natural units);
an online softmax with exp2 over 128-key tiles, the prefix's first, page by
page from the page holding the tile's first visible position (a stage's
slots past the last live page repeat it, masked), then the tail's; P
rounded to bf16 before P V while the row sum takes P unrounded; rows at or
past tail_len, and row tiles with no live row, give zeros. It is held
against ``repro.kernels.paged_prefill_attention.paged_flash_prefill`` in
interpret mode on scattered page tables: per row within 2^-6 of the row's
max |o| (one bf16 ulp is 2^-7; the card's bar) and within the JAX suite's
bf16 bar of 3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_prefill_attention import paged_flash_prefill as jax_prefill

ROW_TOL = 2.0**-6
BF16_TOL = 3e-2
BLOCK = 128                     # query rows and keys of a tile
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
    per_stage = BLOCK // ps
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
                    cols = first * ps + t * BLOCK + torch.arange(BLOCK)[None, :]
                    ok = (rows < tl) & (cols < live)
                    if window:
                        ok = ok & (cols > pl + rows - window)
                    tiles.append((kp[:, pages].reshape(hkv, BLOCK, d),
                                  vp[:, pages].reshape(hkv, BLOCK, d), ok))
            tail_lo = max(0, q0 - window + 1) // BLOCK if window else 0
            for n in range(tail_lo, q_hi // BLOCK + 1):
                c0 = n * BLOCK
                pad = lambda x: torch.nn.functional.pad(x[bi, :, c0:c0 + BLOCK],
                                                        (0, 0, 0, BLOCK - min(BLOCK, st - c0)))
                cols = c0 + torch.arange(BLOCK)[None, :]
                ok = (rows < tl) & (cols <= rows)
                if window:
                    ok = ok & (cols > rows - window)
                tiles.append((pad(kt), pad(vt), ok))
            m = torch.full((hq, qf.shape[1]), NEG_INF)
            l = torch.zeros((hq, qf.shape[1]))
            acc = torch.zeros((hq, qf.shape[1], d))
            for k, v, ok in tiles:
                s = qf @ expand(k).transpose(-1, -2)
                if softcap:
                    x = softcap * torch.tanh(s / d**0.5 / softcap) * LOG2E
                else:
                    x = s * scale2
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


@pytest.mark.parametrize("d", [64, 128])
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


@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_k2_empty_table_matches_jax(d):
    """A table of width 0: only the causal tail is walked."""
    jargs, targs = _inputs(8, 2, d, 16, seed=110 + d, empty_table=True)
    _check(jargs, targs)
