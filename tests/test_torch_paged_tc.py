"""K3/K4's tensor-core arithmetic against the JAX package, on the CPU, over
bf16 pools and (K3q/K4q) over int8 and fp8 pools.

``paged_decode_tc_kernel`` (csrc/paged_decode.cu) runs no CPU mode, so its
arithmetic is written out in float32 (``tc_decode_emulation.paged_k3_k4``,
the walk K7/K8's emulation shares): 64-row stages from the page holding
the first visible position, positions before it masked, slots past the
last live page repeating it, P rounded to bf16 before P V, per-warp states
merged with exp2 weights, a split's (acc, m ln 2, l) through the
natural-unit combine. It is held against
``repro.kernels.paged_decode_attention.paged_flash_decode`` in interpret
mode on scattered page tables: per row within 2^-6 of the row's max |o|
(one bf16 ulp is 2^-7; the card's bar) and within the JAX suite's bf16 bar
of 3e-2. ``paged_decode_q_tc_kernel`` walks the same stages over codes made
by ``repro.cache.quant`` (the same codes and scales on both sides): each
code widened exactly, S's columns times their page's K scale, P's columns
times their page's V scale in float32 and then split into two bf16 parts
for P V, masked positions zeroed by select; held to the JAX kernel's scale
branch at the same bars, also with NaN codes and NaN scales on the null
page that pads each live row's table. At head_dim 256 (gemma) the four
warps take every tile, S the sum in warp order of four partial products
over 64-column chunks of the widened codes, then times its K scales before
the softcap; each warp's slice of P times its V scales goes to P V as two
bf16 parts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import quant as jax_quant
from repro.kernels.paged_decode_attention import paged_flash_decode as jax_decode
from tc_decode_emulation import ROW_TOL, paged_k3_k4, row_err

from repro_torch.cache import quant

BF16_TOL = 3e-2
CAPACITY = 160    # table capacity in positions: 3 stages, 20 pages of 8 or 10 of 16
LENGTHS = [0, 1, 117, CAPACITY]   # empty, one token, a ragged last page, the full table


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops gain nothing from intra-op threads, and under pytest-xdist
    those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(hq, hkv, d, ps, seed):
    """bf16 q and pools (Hkv, P, ps, D), a scattered page table of
    CAPACITY / ps pages a row (page 0 is the null page, never in a table)."""
    rng = np.random.default_rng(seed)
    b, mp = len(LENGTHS), CAPACITY // ps
    num_pages = 1 + b * mp
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, hq, d), (hkv, num_pages, ps, d), (hkv, num_pages, ps, d))]
    table = rng.permutation(np.arange(1, num_pages)).reshape(b, mp).astype(np.int32)
    lengths = np.asarray(LENGTHS, np.int32)
    jax_args = [jnp.asarray(a, jnp.bfloat16) for a in arrays] + [jnp.asarray(table),
                                                                 jnp.asarray(lengths)]
    torch_args = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays] + [
        torch.from_numpy(table), torch.from_numpy(lengths)]
    return jax_args, torch_args


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(25, 5), (32, 8), (32, 1)], ids=["g5", "g4", "g32"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("window,softcap", [(None, None), (50, 30.0)],
                         ids=["full", "window_softcap"])
def test_tensor_core_k3_k4_arithmetic_matches_jax(d, hq, hkv, ps, num_splits, window,
                                                   softcap):
    """Rows of 0, 1, 117 (a ragged last page) and 160 (the full table)
    tokens; with window 50 the first visible position (67 and 110) falls
    mid-page, so the first stage starts before it and masks the rows in
    between. Three splits put split starts inside a 64-row stage (20 pages
    of 8 split 7 + 7 + 6)."""
    jargs, targs = _inputs(hq, hkv, d, ps, seed=80 + d + ps)
    kw = dict(window=window, softcap=softcap, num_splits=num_splits)
    oj = jax_decode(*jargs, interpret=True, **kw)
    ot = paged_k3_k4(*targs, **kw)
    assert row_err(oj, ot) < ROW_TOL
    assert float(np.abs(np.asarray(oj, np.float32) - ot.float().numpy()).max()) < BF16_TOL
    assert float(ot[0].float().abs().max()) == 0.0
    # Rows past each length inside its last live page change nothing: the
    # stages read them (and repeat that page into surplus slots), masked.
    q, kp, vp, table, lengths = targs
    kp2, vp2 = kp.clone(), vp.clone()
    big = torch.tensor(1e4, dtype=torch.bfloat16)
    for bi, length in enumerate(LENGTHS):
        if length % ps:
            page = int(table[bi, length // ps])
            kp2[:, page, length % ps:] = big
            vp2[:, page, length % ps:] = -big
    assert not torch.equal(kp, kp2)
    assert torch.equal(ot, paged_k3_k4(q, kp2, vp2, table, lengths, **kw))


@pytest.mark.parametrize("hq,hkv", [(8, 4), (4, 1)], ids=["gemma2", "gemma3"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("num_splits", [1, 3])
def test_tensor_core_k3_k4_d256_arithmetic_matches_jax(hq, hkv, ps, num_splits):
    """At head_dim 256 the four warps take every tile, one state a cell,
    S summed from four partial products over 64-column chunks of D; the
    rows and splits of the test above, gemma's groups of 2 and 4, window 50
    and softcap 50."""
    jargs, targs = _inputs(hq, hkv, 256, ps, seed=90 + ps)
    kw = dict(window=50, softcap=50.0, num_splits=num_splits)
    oj = jax_decode(*jargs, interpret=True, **kw)
    ot = paged_k3_k4(*targs, **kw)
    assert row_err(oj, ot) < ROW_TOL
    assert float(np.abs(np.asarray(oj, np.float32) - ot.float().numpy()).max()) < BF16_TOL
    assert float(ot[0].float().abs().max()) == 0.0


def _quant_inputs(hq, hkv, d, ps, seed, kv_dtype, nan_null):
    """bf16 q and int8 or fp8 pools (Hkv, P, ps, D) quantized by
    ``repro.cache.quant`` from seeded float32 values of a different
    magnitude on every page (K up to 4x, V up to 1x a standard normal), the
    same codes and scales handed to both packages; the scattered table of
    ``_inputs``, or, with ``nan_null``, each row's live pages and then the
    null page (0), whose codes are NaN bits in e4m3 (0x7F) and whose scales
    are NaN."""
    rng = np.random.default_rng(seed)
    b, mp = len(LENGTHS), CAPACITY // ps
    num_pages = 1 + b * mp
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    table = rng.permutation(np.arange(1, num_pages)).reshape(b, mp).astype(np.int32)
    if nan_null:
        for i, n in enumerate(LENGTHS):
            table[i, -(-n // ps):] = 0
    jax_pools, torch_pools = [], []
    for top in (4.0, 1.0):
        x = rng.standard_normal((hkv, num_pages, ps, d)) * rng.uniform(
            0.1, top, (hkv, num_pages, 1, 1))
        codes, scale_tab = jax_quant.quantize_pages(jnp.asarray(x, jnp.float32), kv_dtype)
        raw = np.array(np.asarray(codes).view(np.uint8))
        scale_tab = np.array(scale_tab, np.float32)
        if nan_null:
            raw[:, 0] = 0x7F
            scale_tab[:, 0] = np.nan
        jax_pools += [jnp.asarray(raw.view(np.asarray(codes).dtype)), jnp.asarray(scale_tab)]
        torch_pools += [torch.from_numpy(raw).view(quant.storage_dtype(kv_dtype)),
                        torch.from_numpy(scale_tab)]
    lengths = np.asarray(LENGTHS, np.int32)
    jk, jks, jv, jvs = jax_pools
    tk, tks, tv, tvs = torch_pools
    jax_args = ([jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(table), jnp.asarray(lengths)],
                dict(k_scales=jks, v_scales=jvs))
    torch_args = ([torch.from_numpy(q).to(torch.bfloat16), tk, tv, torch.from_numpy(table),
                   torch.from_numpy(lengths)], dict(k_scale_tab=tks, v_scale_tab=tvs))
    return jax_args, torch_args


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(25, 5), (32, 8), (32, 1)], ids=["g5", "g4", "g32"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("window,softcap", [(None, None), (50, 30.0)],
                         ids=["full", "window_softcap"])
def test_tensor_core_k3q_k4q_arithmetic_matches_jax(kv_dtype, d, hq, hkv, ps, num_splits,
                                                     window, softcap):
    """The rows and splits of the bf16 test over int8 and fp8 pools whose
    every page has its own scale; window 50 starts mid-page, three splits
    start inside a stage."""
    (jargs, jkw), (targs, tkw) = _quant_inputs(hq, hkv, d, ps, 180 + d + ps, kv_dtype,
                                               nan_null=False)
    kw = dict(window=window, softcap=softcap, num_splits=num_splits)
    oj = jax_decode(*jargs, interpret=True, **jkw, **kw)
    ot = paged_k3_k4(*targs, **tkw, **kw)
    assert row_err(oj, ot) < ROW_TOL
    assert float(np.abs(np.asarray(oj, np.float32) - ot.float().numpy()).max()) < BF16_TOL
    assert float(ot[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("hq,hkv,window,softcap", [(8, 4, 50, 50.0), (4, 1, 70, None)],
                         ids=["gemma2", "gemma3"])
@pytest.mark.parametrize("num_splits", [1, 3])
def test_tensor_core_k3q_k4q_d256_arithmetic_matches_jax(kv_dtype, hq, hkv, window, softcap,
                                                          num_splits):
    """K3q / K4q at head_dim 256 over int8 and fp8 pools, pages of 16: S
    summed in warp order from four partial products over 64-column chunks
    of widened codes, times each column's K scale before the softcap
    (``softcap_log2``), P times its V scales split into two bf16 parts,
    the row sums kept per key slice; gemma2's groups of 2 with window 50
    and softcap 50, gemma3's group of 4 over one kv head with window 70."""
    (jargs, jkw), (targs, tkw) = _quant_inputs(hq, hkv, 256, 16, 280 + hq, kv_dtype,
                                               nan_null=False)
    kw = dict(window=window, softcap=softcap, num_splits=num_splits)
    oj = jax_decode(*jargs, interpret=True, **jkw, **kw)
    ot = paged_k3_k4(*targs, **tkw, **kw)
    assert row_err(oj, ot) < ROW_TOL
    assert float(np.abs(np.asarray(oj, np.float32) - ot.float().numpy()).max()) < BF16_TOL
    assert float(ot[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("num_splits", [1, 3])
def test_tensor_core_k3q_k4q_ignore_nan_garbage(kv_dtype, num_splits):
    """Live rows' tables padded with the null page, its codes NaN bits and
    its scales NaN: the walk never loads a page past a row's last live one
    (a last stage's surplus slots repeat that page), so every row is finite
    and matches the JAX kernel, which skips those pages. Then the same NaN
    bits (127 in int8) in the rows past each length inside its last live
    page, which the walk loads and masks: zeroed by select, they change no
    bit of the output."""
    _check_nan_garbage(kv_dtype, 32, 8, 128, num_splits, None)


def test_tensor_core_k3q_k4q_d256_ignore_nan_garbage():
    """The test above at head_dim 256 over fp8 codes, gemma2's group of 2
    and softcap 50, one pass."""
    _check_nan_garbage("fp8", 8, 4, 256, 1, 50.0)


def _check_nan_garbage(kv_dtype, hq, hkv, d, num_splits, softcap):
    (jargs, jkw), (targs, tkw) = _quant_inputs(hq, hkv, d, 16, 190, kv_dtype, nan_null=True)
    kw = dict(window=None, softcap=softcap, num_splits=num_splits)
    oj = jax_decode(*jargs, interpret=True, **jkw, **kw)
    ot = paged_k3_k4(*targs, **tkw, **kw)
    assert bool(torch.isfinite(ot.float()).all())
    assert row_err(oj, ot) < ROW_TOL
    assert float(np.abs(np.asarray(oj, np.float32) - ot.float().numpy()).max()) < BF16_TOL
    q, kc, vc, table, lengths = targs
    kc2, vc2 = kc.clone(), vc.clone()
    for bi, length in enumerate(LENGTHS):
        if length % 16:
            page = int(table[bi, length // 16])
            for codes in (kc2, vc2):
                codes.view(torch.uint8)[:, page, length % 16:] = 0x7F
    assert not torch.equal(kc.view(torch.uint8), kc2.view(torch.uint8))
    assert torch.equal(ot, paged_k3_k4(q, kc2, vc2, table, lengths, **tkw, **kw))
