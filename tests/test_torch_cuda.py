"""Card-only tests: every CUDA kernel of the port against its plain PyTorch
version on the card, at small shapes, plus the paged and dense engines and
one train step on the kernels against the same on the plain versions.

Run them on a machine with a Hopper card and ``nvcc``::

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Without a card each test skips, decided inside the ``cuda`` fixture, so
every pytest-xdist worker collects the same tests. The file imports no JAX:
the machine with the card has none. Bars: 2e-5 absolute at float32 (the
kernels and the plain versions both compute in float32; only the order of
the sums differs); at bfloat16, per row, max |o - ref| within 2^-6 of the
row's max |ref| (two roundings to bf16 differ by one ulp, at most 2^-7 of
the row's max; a row of ref that is all zero must be exactly zero), and
lse within 1e-5, as ``chip_smoke.py`` holds them. K1 in bf16 runs on the
tensor cores and rounds P to bf16 before P V; in float32 it runs on the CUDA
cores and is held at 2e-5. K2, K3/K4 and K7/K8 likewise: bf16 on the
tensor cores (P rounded to bf16), float32 on the CUDA cores. Over int8 and
fp8 pools (codes and per-page scales) K2, K3 and K4 run their quantized
entries on the tensor cores for bf16 q (K2q: each code times its page's
scale rounded once to bf16, bit for bit K2 over the dequantized values in
bf16; K3q/K4q: the codes widened exactly to bf16, P scaled and rounded to
bf16) and on the CUDA cores for float32 q; each is held at the bar of q's
dtype. K9 (float32 in and out, its products on the tensor cores in 3xTF32, about
22 bits each) is held per (b, chunk, head) slice: max |y - ref| within 1e-5
of the slice's max |ref| (sums of at most q + N terms taken in another
order; a dropped key tile moves y by a large fraction of its max, a single
TF32 pass by ~5e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import (gemma2_2b, gemma3_1b, hymba_1_5b, llama3_8b,
                                 llama_3_2_vision_11b, mamba2_1_3b, musicgen_medium)
from repro_torch.kernels import decode_attention as dd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pd
from repro_torch.kernels import paged_prefill_attention as pp
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.models import ssm, transformer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving import LLMEngine, Request
from repro_torch.training import train_step as ts

pytestmark = pytest.mark.requires_cuda

F32_TOL = 2e-5
ROW_TOL = 2.0**-6
SSD_TOL = 1e-5
LSE_TOL = 1e-5
HEADS = [(8, 2), (4, 4), (4, 1)]          # GQA, MHA, MQA
HEAD_IDS = ["gqa", "mha", "mqa"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _row_err(a, ref) -> float:
    diff = (a.float() - ref.float()).abs().amax(-1)
    den = ref.float().abs().amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


def _close(a, ref) -> bool:
    """The bar of ``a``'s dtype (module docstring)."""
    if a.dtype == torch.float32:
        return _err(a, ref) < F32_TOL
    return _row_err(a, ref) < ROW_TOL


# -- K1 ------------------------------------------------------------------------

# The distinct launches; the paper's four names are aliases of the two orders.
MAPPINGS = {"head_first": fa.MappingConfig(order=fa.HEAD_FIRST),
            "block_first": fa.MappingConfig(order=fa.BLOCK_FIRST),
            "sawtooth": fa.MappingConfig(order=fa.HEAD_FIRST, traversal="sawtooth")}


@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
def test_flash_fwd_every_mapping_matches_plain(cuda, mapping, hq, hkv):
    rng = np.random.default_rng(0)
    q = _randn(rng, (2, hq, 200, 128), cuda)
    k, v = _randn(rng, (2, hkv, 200, 128), cuda), _randn(rng, (2, hkv, 200, 128), cuda)
    o, lse = fa.flash_attention_fwd(q, k, v, mapping=MAPPINGS[mapping], causal=True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _err(o, o_ref) < F32_TOL and _err(lse, lse_ref) < F32_TOL


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kw", [dict(causal=True, window=37, softcap=20.0),
                                dict(causal=False, kv_len=150),
                                dict(causal=True, kv_len=90)],
                         ids=["window_softcap", "noncausal_kvlen", "causal_kvlen"])
def test_flash_fwd_masks_match_plain(cuda, dtype, d, kw):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    q = _randn(rng, (1, 8, 130, d), cuda, dt)
    k, v = _randn(rng, (1, 2, 170, d), cuda, dt), _randn(rng, (1, 2, 170, d), cuda, dt)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dt and _close(o, o_ref)
    assert _err(lse, lse_ref) < LSE_TOL


@pytest.mark.parametrize("window", [None, 100])
def test_flash_fwd_hymba_group_of_five(cuda, window):
    """hymba-1.5b's head layout: Hq 25 over Hkv 5 (a GQA group of 5), D 64,
    with and without a window."""
    rng = np.random.default_rng(15)
    q = _randn(rng, (1, 25, 300, 64), cuda, torch.bfloat16)
    k, v = (_randn(rng, (1, 5, 300, 64), cuda, torch.bfloat16) for _ in range(2))
    o = ops.flash_attention(q, k, v, causal=True, window=window)
    ref, _ = fa.flash_attention_fwd_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert _close(o, ref)


def test_flash_fwd_fully_masked_rows(cuda):
    """kv_len 0: every row is fully masked -> o = 0, lse = -1e30."""
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (1, 2, 64, 64), cuda) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=False, kv_len=0)
    torch.cuda.synchronize()
    assert float(o.abs().max()) == 0.0
    assert torch.equal(lse, torch.full_like(lse, -1e30))


def test_ops_flash_attention_pads_odd_lengths(cuda):
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 8, 77, 128), cuda)
    k, v = _randn(rng, (2, 2, 77, 128), cuda), _randn(rng, (2, 2, 77, 128), cuda)
    got = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=True)[0]
    torch.cuda.synchronize()
    assert got.shape == q.shape and _err(got, want) < F32_TOL


# -- K1 in bf16: the tensor-core kernel ----------------------------------------

# (Hq, Hkv, Sq, Skv, D): groups of 4 and 5, lengths that are not multiples of
# the kernel's 128-row tiles, Sq < Skv.
TC_SHAPES = [(32, 8, 130, 170, 128), (25, 5, 130, 170, 64), (32, 8, 77, 77, 64),
             (25, 5, 200, 200, 128), (8, 2, 200, 333, 128), (8, 2, 200, 333, 64)]
TC_MASKS = {"causal": dict(causal=True), "causal_kvlen": dict(causal=True, kv_len=-31),
            "noncausal_kvlen": dict(causal=False, kv_len=-45),
            "window_softcap": dict(causal=True, window=37, softcap=20.0)}


@pytest.mark.parametrize("mask", sorted(TC_MASKS))
@pytest.mark.parametrize("shape", TC_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_fwd_tensor_cores_match_plain(cuda, shape, mask):
    """bf16 goes to the tensor-core entry (its own count moves), held per
    row within 2^-6 and lse within 1e-5; a negative kv_len here counts back
    from Skv."""
    hq, hkv, sq, skv, d = shape
    kw = dict(TC_MASKS[mask])
    if "kv_len" in kw:
        kw["kv_len"] += skv
    rng = np.random.default_rng(70)
    q = _randn(rng, (2, hq, sq, d), cuda, torch.bfloat16)
    k, v = (_randn(rng, (2, hkv, skv, d), cuda, torch.bfloat16) for _ in range(2))
    kernels.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd"] == counts["flash_attention_fwd_tc"] == 1
    assert o.dtype == torch.bfloat16 and _row_err(o, o_ref) < ROW_TOL
    assert _err(lse, lse_ref) < LSE_TOL


@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_tensor_cores_fully_masked_rows(cuda, d):
    """kv_len 0: o exactly 0 and lse exactly -1e30, with no NaN."""
    rng = np.random.default_rng(71)
    q = _randn(rng, (1, 8, 200, d), cuda, torch.bfloat16)
    k, v = (_randn(rng, (1, 2, 150, d), cuda, torch.bfloat16) for _ in range(2))
    for causal in (True, False):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, kv_len=0)
        torch.cuda.synchronize()
        assert torch.equal(o, torch.zeros_like(o))
        assert torch.equal(lse, torch.full_like(lse, -1e30))


def test_flash_fwd_tensor_cores_orders_agree_exactly(cuda):
    """Head-first and block-first change which blocks run together, never a
    block's sums: the same bits. Sawtooth walks the KV tiles of odd q
    blocks backwards, so it sums in another order: within the bars."""
    rng = np.random.default_rng(72)
    q = _randn(rng, (2, 32, 700, 128), cuda, torch.bfloat16)
    k, v = (_randn(rng, (2, 8, 700, 128), cuda, torch.bfloat16) for _ in range(2))
    outs = {name: fa.flash_attention_fwd(q, k, v, mapping=m, causal=True)
            for name, m in MAPPINGS.items()}
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs["head_first"], outs["block_first"]))
    for o, lse in outs.values():
        assert _row_err(o, o_ref) < ROW_TOL and _err(lse, lse_ref) < LSE_TOL


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [None, 90])
def test_flash_fwd_per_row_offsets_match_plain(cuda, dtype, d, window):
    """K1 with per-row query offsets and kv_len: three rows of 150 queries
    at 0, 37 and 300 over 500 keys, the second's kv_len 5 short of its last
    query; an int offset equals the same offset per row, and offset 0 as
    arrays gives the null pointers' bits."""
    rng = np.random.default_rng(73)
    q = _randn(rng, (3, 8, 150, d), cuda, DTYPES[dtype])
    k, v = (_randn(rng, (3, 2, 500, d), cuda, DTYPES[dtype]) for _ in range(2))
    kw = dict(causal=True, window=window,
              q_offset=torch.tensor([0, 37, 300], dtype=torch.int32, device=cuda),
              kv_len=torch.tensor([150, 182, 450], dtype=torch.int32, device=cuda))
    kernels.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
    same_int = fa.flash_attention_fwd(q, k, v, causal=True, window=window, q_offset=120)
    per_row = fa.flash_attention_fwd(q, k, v, causal=True, window=window,
                                     q_offset=torch.full((3,), 120, device=cuda))
    zero = fa.flash_attention_fwd(q, k, v, causal=True, window=window,
                                  q_offset=torch.zeros((3,), device=cuda),
                                  kv_len=torch.full((3,), 500, device=cuda))
    null = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_fwd"] == 5
    assert _close(o, o_ref) and _err(lse, lse_ref) < (LSE_TOL if dtype == "bf16" else F32_TOL)
    assert all(torch.equal(a, b) for a, b in zip(same_int, per_row))
    assert all(torch.equal(a, b) for a, b in zip(zero, null))


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
def test_gather_route_matches_k2_on_the_card(cuda, kv_dtype):
    """The paged extend's gather route (the prefix gathered into stripes,
    then K1 with offsets) against K2 over the same bf16 (or int8 / fp8)
    pool: within the bf16 bars of each other, rows past tail_len zero, and
    the route launches K1, never K2."""
    from repro_torch.cache import quant
    from repro_torch.kernels import plan as plan_lib

    rng = np.random.default_rng(74)
    b, st, ps, mp = 3, 140, 16, 20
    kp, vp = (_randn(rng, (8, 1 + b * mp, ps, 128), cuda) for _ in range(2))
    table = torch.from_numpy(rng.permutation(np.arange(1, 1 + b * mp)).reshape(b, mp)
                             .astype(np.int32)).to(cuda)
    q = _randn(rng, (b, 32, st, 128), cuda, torch.bfloat16)
    kt, vt = (_randn(rng, (b, 8, st, 128), cuda, torch.bfloat16) for _ in range(2))
    plen = torch.tensor([300, 0, mp * ps], dtype=torch.int32, device=cuda)
    tlen = torch.tensor([st, 9, 1], dtype=torch.int32, device=cuda)
    scales = {}
    if kv_dtype == "fp32":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    else:
        (kp, ks), (vp, vs) = (quant.quantize_pages(p, kv_dtype) for p in (kp, vp))
        scales = dict(k_scales=ks, v_scales=vs)
    args = (q, kp, vp, table, kt, vt, plen, tlen)
    shape = (b, 32, 8, st, mp * ps + st, 128)
    outs = {}
    for impl in ("cuda", plan_lib.GATHER):
        plan = plan_lib.plan_attention(shape, phase=plan_lib.EXTEND, kv_layout=plan_lib.PAGED,
                                       page_size=ps, prefix_pages=mp, device_type="cuda",
                                       impl=impl)
        kernels.reset_launch_counts()
        outs[impl] = ops.paged_prefill_attention(*args, plan=plan, **scales)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        k2 = counts["paged_flash_prefill"] + counts["paged_flash_prefill_q"]
        assert (counts["flash_attention_fwd_tc"], k2) == ((0, 1) if impl == "cuda" else (1, 0))
    assert _row_err(outs[plan_lib.GATHER], outs["cuda"]) < ROW_TOL
    for i, t in enumerate(tlen.tolist()):
        assert not outs[plan_lib.GATHER][i, :, t:].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_fwd_refuses_misaligned_or_strided_inputs(cuda, dtype):
    """Both K1 kernels read 16-byte rows (the bf16 one through TMA maps):
    an input that starts off a 16-byte boundary, or is not contiguous,
    raises instead of launching."""
    dt = DTYPES[dtype]
    shape = (1, 4, 64, 128)
    n = int(np.prod(shape))
    good = torch.zeros(shape, device=cuda, dtype=dt)
    off = torch.zeros(n + 8, device=cuda, dtype=dt)[1:n + 1].view(shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    strided = good.transpose(2, 3).contiguous().transpose(2, 3)
    kernels.reset_launch_counts()
    for bad in (off, strided):
        with pytest.raises(ValueError):
            fa.flash_attention_fwd(bad, good, good)
        with pytest.raises(ValueError):
            fa.flash_attention_fwd(good, good[:, :2].contiguous(), bad[:, :2])
    assert kernels.launch_counts()["flash_attention_fwd"] == 0


# -- K5 / K6 -------------------------------------------------------------------


def _slice_err(g, ref) -> float:
    """Max over (b, head) slices of max |g - ref| / max |ref| (a slice of
    ref that is all zero must be exactly zero)."""
    diff = (g.float() - ref.float()).abs().flatten(2).amax(-1)
    den = ref.float().abs().flatten(2).amax(-1)
    zero_ok = torch.where(diff > 0, float("inf"), 0.0)
    return float(torch.where(den > 0, diff / den.clamp_min(1e-30), zero_ok).max())


#: Gradient bars per (b, head) slice: float32 sums in another order differ
#: by ~1e-6 of a slice's max; bf16 outputs by one rounding, as the forward's.
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: ROW_TOL}


def _bwd_case(rng, dev, dt, hq, hkv, sq, skv, d, **kw):
    q = _randn(rng, (2, hq, sq, d), dev, dt)
    k, v = _randn(rng, (2, hkv, skv, d), dev, dt), _randn(rng, (2, hkv, skv, d), dev, dt)
    do = _randn(rng, (2, hq, sq, d), dev, dt)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    return q, k, v, o.contiguous(), lse.contiguous(), do


def _bwd_routes(counts, dt, n=1) -> bool:
    """``n`` K5 and ``n`` K6 launches, on the bf16 tensor-core kernels (the
    ``_tc`` counters) for bf16, on the 3xTF32 ones (``_tf32``) for float32."""
    tc = n * int(dt == torch.bfloat16)
    return (counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == n
            and counts["flash_attention_bwd_dq_tc"] == counts["flash_attention_bwd_dkv_tc"] == tc
            and counts["flash_attention_bwd_dq_tf32"] == counts["flash_attention_bwd_dkv_tf32"]
            == n - tc)


@pytest.mark.parametrize("order", [fa.HEAD_FIRST, fa.BLOCK_FIRST])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape,kw", [
    ((8, 2, 192, 192), dict(causal=True)),
    ((8, 2, 130, 130), dict(causal=True, window=37, softcap=20.0)),
    ((4, 4, 77, 77), dict(causal=True)),
    ((4, 1, 130, 170), dict(causal=False, kv_len=150)),
], ids=["gqa_causal", "gqa_window_softcap_odd", "mha_odd", "mqa_noncausal_kvlen"])
def test_flash_bwd_matches_plain(cuda, order, dtype, d, shape, kw):
    """bf16 runs the bf16 tensor-core K5 / K6 (the ``_tc`` counters move),
    float32 the 3xTF32 ones (the ``_tf32`` counters), each per (b, head)
    slice within its dtype's bar."""
    dt = DTYPES[dtype]
    args = _bwd_case(np.random.default_rng(50), cuda, dt, *shape, d, **kw)
    kernels.reset_launch_counts()
    got = fb.flash_attention_bwd(*args, mapping=fa.MappingConfig(order=order), **kw)
    counts = kernels.launch_counts()
    want = fb.flash_attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _bwd_routes(counts, dt), counts
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape, name
        assert _slice_err(g, w) <= GRAD_TOL[dt], name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_bwd_fully_masked_rows(cuda, dtype):
    """kv_len 0 masks every row (lse -1e30): every gradient exactly 0, no NaN."""
    dt = DTYPES[dtype]
    q, k, v, o, lse, do = _bwd_case(np.random.default_rng(51), cuda, dt,
                                    4, 2, 64, 64, 64, causal=False, kv_len=0)
    kernels.reset_launch_counts()
    dq, dk, dv = fb.flash_attention_bwd(q, k, v, o, lse, do, causal=False, kv_len=0)
    torch.cuda.synchronize()
    assert _bwd_routes(kernels.launch_counts(), dt)
    assert float(dq.abs().max()) == float(dk.abs().max()) == float(dv.abs().max()) == 0.0


@pytest.mark.parametrize("window", [None, 100])
def test_flash_bwd_hymba_group_of_five(cuda, window):
    """hymba-1.5b's head layout on the tensor-core K5 / K6: Hq 25 over Hkv 5
    (K6 sums a GQA group of 5), D 64, with and without a window."""
    kw = dict(causal=True, window=window)
    args = _bwd_case(np.random.default_rng(57), cuda, torch.bfloat16, 25, 5, 300, 300, 64, **kw)
    kernels.reset_launch_counts()
    got = fb.flash_attention_bwd(*args, **kw)
    counts = kernels.launch_counts()
    want = fb.flash_attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _bwd_routes(counts, torch.bfloat16), counts
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _slice_err(g, w) <= ROW_TOL, name


def test_flash_bwd_orders_agree_exactly(cuda):
    """An order changes which blocks run together, never a block's sums:
    the tensor-core K5 / K6 give the same bits under both."""
    args = _bwd_case(np.random.default_rng(52), cuda, torch.bfloat16, 8, 2, 256, 256, 128,
                     causal=True)
    kernels.reset_launch_counts()
    hf = fb.flash_attention_bwd(*args, mapping=fa.MappingConfig(order=fa.HEAD_FIRST))
    bf = fb.flash_attention_bwd(*args, mapping=fa.MappingConfig(order=fa.BLOCK_FIRST))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd_dq_tc"] == counts["flash_attention_bwd_dkv_tc"] == 2
    assert all(torch.equal(a, b) for a, b in zip(hf, bf))


def test_flash_bwd_f32_orders_and_reruns_agree_exactly(cuda):
    """The float32 K5 / K6 (3xTF32) give the same bits head-first and
    block-first, and in 100 reruns: every output element is summed by one
    thread in a fixed order, the two halves of a block's walk added once,
    in a fixed order, at the end. Each run within GRAD_TOL of the plain
    backward per slice."""
    kw = dict(causal=True)
    args = _bwd_case(np.random.default_rng(58), cuda, torch.float32, 8, 2, 300, 300, 128, **kw)
    kernels.reset_launch_counts()
    first = fb.flash_attention_bwd(*args, mapping=fa.MappingConfig(order=fa.HEAD_FIRST), **kw)
    other = fb.flash_attention_bwd(*args, mapping=fa.MappingConfig(order=fa.BLOCK_FIRST), **kw)
    torch.cuda.synchronize()
    assert _bwd_routes(kernels.launch_counts(), torch.float32, n=2)
    assert all(torch.equal(a, b) for a, b in zip(first, other))
    want = fb.flash_attention_bwd_plain(*args, **kw)
    assert max(_slice_err(g, w) for g, w in zip(first, want)) <= GRAD_TOL[torch.float32]
    for _ in range(100):
        again = fb.flash_attention_bwd(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("window", [None, 100])
def test_flash_bwd_f32_hymba_group_of_five(cuda, window):
    """hymba-1.5b's head layout on the float32 K5 / K6 (3xTF32): Hq 25 over
    Hkv 5 (K6 sums a GQA group of 5), D 64, with and without a window, per
    slice within GRAD_TOL."""
    kw = dict(causal=True, window=window)
    args = _bwd_case(np.random.default_rng(59), cuda, torch.float32, 25, 5, 300, 300, 64, **kw)
    kernels.reset_launch_counts()
    got = fb.flash_attention_bwd(*args, **kw)
    counts = kernels.launch_counts()
    want = fb.flash_attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _bwd_routes(counts, torch.float32), counts
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _slice_err(g, w) <= GRAD_TOL[torch.float32], name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_bwd_refuses_misaligned_or_strided_inputs(cuda, dtype):
    """K5 / K6 read 16-byte rows (bf16 through TMA maps): an input that
    starts off a 16-byte boundary, or is not contiguous, raises instead of
    launching."""
    dt = DTYPES[dtype]
    shape = (1, 4, 64, 128)
    n = int(np.prod(shape))
    good = torch.zeros(shape, device=cuda, dtype=dt)
    off = torch.zeros(n + 8, device=cuda, dtype=dt)[1:n + 1].view(shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    strided = good.transpose(2, 3).contiguous().transpose(2, 3)
    stats = torch.zeros((1, 4, 64), device=cuda)
    kv = good[:, :2].contiguous()
    kernels.reset_launch_counts()
    for bad in (off, strided):
        for args in ((bad, kv, kv, good), (good, bad[:, :2], kv, good),
                     (good, kv, kv, bad)):
            for fn in (fb.flash_attention_bwd_dq, fb.flash_attention_bwd_dkv):
                with pytest.raises(ValueError):
                    fn(*args, stats, stats)
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == 0


def test_ops_flash_attention_backward_runs_k1_k5_k6(cuda):
    rng = np.random.default_rng(53)
    leaves = [_randn(rng, shape, cuda).requires_grad_(True)
              for shape in ((2, 8, 77, 128), (2, 2, 77, 128), (2, 2, 77, 128))]
    do = _randn(rng, (2, 8, 77, 128), cuda)
    kernels.reset_launch_counts()
    out = ops.flash_attention(*leaves, causal=True)
    (out * do).sum().backward()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == 1
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    o_ref, _ = fa.flash_attention_fwd_plain(*ref, causal=True)
    (o_ref * do).sum().backward()
    for t, r in zip(leaves, ref):
        assert _slice_err(t.grad, r.grad) <= GRAD_TOL[torch.float32]


def test_kernels_without_a_backward_refuse_grad(cuda):
    """A wrapper whose kernel writes its output through a pointer raises when
    autograd would need a gradient, instead of returning a tensor with no
    grad_fn; under no_grad it runs."""
    rng = np.random.default_rng(54)
    q = _randn(rng, (1, 4, 64, 64), cuda).requires_grad_(True)
    k, v = _randn(rng, (1, 2, 64, 64), cuda), _randn(rng, (1, 2, 64, 64), cuda)
    with pytest.raises(RuntimeError, match="flash_attention_fwd"):
        fa.flash_attention_fwd(q, k, v)
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(RuntimeError, match="flash_attention_bwd_dq"):   # double backward
        fb.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o))
    args = list(_prefill_inputs(np.random.default_rng(55), cuda, torch.float32, 8, 2))
    args[0] = args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="paged_flash_prefill"):
        pp.paged_flash_prefill(*args)
    dargs = list(_decode_inputs(np.random.default_rng(56), cuda, torch.float32, 8, 2))
    dargs[1] = dargs[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="paged_flash_decode"):
        pd.paged_flash_decode(*dargs)
    with torch.no_grad():
        pd.paged_flash_decode(*dargs)
    torch.cuda.synchronize()


# -- K2 ------------------------------------------------------------------------


def _prefill_inputs(rng, dev, dt, hq, hkv, d=128, ps=16, st=70, mp=5, num_pages=24):
    b = 2
    q = _randn(rng, (b, hq, st, d), dev, dt)
    kt, vt = _randn(rng, (b, hkv, st, d), dev, dt), _randn(rng, (b, hkv, st, d), dev, dt)
    kp, vp = (_randn(rng, (hkv, num_pages, ps, d), dev, dt) for _ in range(2))
    table = np.stack([rng.permutation(np.arange(1, num_pages))[:mp] for _ in range(b)])
    table = torch.from_numpy(table.astype(np.int32)).to(dev)
    plen = torch.tensor([mp * ps - 7, 17], dtype=torch.int32, device=dev)
    tlen = torch.tensor([st, 41], dtype=torch.int32, device=dev)
    return q, kp, vp, table, kt, vt, plen, tlen


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("window,softcap", [(None, None), (50, 30.0)],
                         ids=["full", "window_softcap"])
def test_paged_prefill_matches_plain(cuda, dtype, hq, hkv, window, softcap):
    dt = DTYPES[dtype]
    args = _prefill_inputs(np.random.default_rng(10), cuda, dt, hq, hkv)
    o = pp.paged_flash_prefill(*args, window=window, softcap=softcap)
    o_ref = pp.paged_flash_prefill_plain(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert _close(o, o_ref)
    assert float(o[1, :, 41:].abs().max()) == 0.0        # rows past tail_len


def test_paged_prefill_empty_table(cuda):
    q, kp, vp, _, kt, vt, _, tlen = _prefill_inputs(np.random.default_rng(11), cuda,
                                                    torch.float32, 8, 2)
    table = torch.zeros((2, 0), dtype=torch.int32, device=cuda)
    plen = torch.zeros((2,), dtype=torch.int32, device=cuda)
    args = (q, kp, vp, table, kt, vt, plen, tlen)
    o = pp.paged_flash_prefill(*args)
    torch.cuda.synchronize()
    assert _err(o, pp.paged_flash_prefill_plain(*args)) < F32_TOL


# -- K2 in bf16: the tensor-core kernel ----------------------------------------

# name -> (St, mp, prefix_len, tail_len) at a page size of ps, the table
# scattered over 1 + B * mp pages (page 0 the null page): a prefix that is no
# page multiple on a table of 11 pages (not a multiple of 128 / ps for any
# ps up to 64); two row tiles (St 200) over a prefix of ~300 positions; an
# empty table; tails padded past tail_len, one of them to nothing.
TC_PREFILL = {
    "ragged": lambda ps: (70, 11, [11 * ps - 5, 17], [70, 41]),
    "two_row_tiles": lambda ps: (200, -(-300 // ps), [300, 129], [200, 150]),
    "empty_table": lambda ps: (150, 0, [0, 0], [150, 97]),
    "empty_tail": lambda ps: (40, 3, [3 * ps, 2 * ps + 1], [0, 40]),
}


def _tc_prefill_inputs(rng, dev, hq, hkv, d, ps, case):
    st, mp, plen, tlen = TC_PREFILL[case](ps)
    b = 2
    num_pages = 1 + b * mp
    q = _randn(rng, (b, hq, st, d), dev, torch.bfloat16)
    kt, vt = (_randn(rng, (b, hkv, st, d), dev, torch.bfloat16) for _ in range(2))
    kp, vp = (_randn(rng, (hkv, num_pages, ps, d), dev, torch.bfloat16) for _ in range(2))
    table = rng.permutation(np.arange(1, num_pages)).reshape(b, mp).astype(np.int32)
    as_int = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return (q, kp, vp, torch.from_numpy(table).to(dev), kt, vt, as_int(plen), as_int(tlen))


def _prefill_routes(counts, dtype) -> bool:
    """Every K2 launch went to the tensor-core kernel (bf16), or none did
    (float32)."""
    total, tc = counts["paged_flash_prefill"], counts["paged_flash_prefill_tc"]
    return total > 0 and tc == (total if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("ps", [8, 16, 32, 64])
@pytest.mark.parametrize("case", sorted(TC_PREFILL))
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (25, 5, 64), (8, 8, 128)],
                         ids=["llama", "hymba", "group1"])
@pytest.mark.parametrize("window,softcap", [(None, None), (75, 30.0)],
                         ids=["full", "window_softcap"])
def test_paged_prefill_tensor_cores_match_plain(cuda, ps, case, hq, hkv, d, window, softcap):
    """bf16 goes to the tensor-core entry (its own count moves), held per
    row within 2^-6; rows at or past tail_len are exact zeros. A prefix
    stage takes 128 / ps pages: the last one of an 11-page table leaves
    slots that repeat the last live page, masked; window 75 starts the walk
    at a page inside the prefix for every row tile past its first rows."""
    args = _tc_prefill_inputs(np.random.default_rng(90 + ps), cuda, hq, hkv, d, ps, case)
    kw = dict(window=window, softcap=softcap)
    kernels.reset_launch_counts()
    o = pp.paged_flash_prefill(*args, **kw)
    assert _prefill_routes(kernels.launch_counts(), torch.bfloat16)
    o_ref = pp.paged_flash_prefill_plain(*args, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and _row_err(o, o_ref) < ROW_TOL
    for bi, t in enumerate(args[7].tolist()):
        assert float(o[bi, :, t:].float().abs().sum()) == 0.0


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_prefill_tensor_cores_ignore_rows_past_prefix(cuda, ps, window):
    """The tensor-core kernel loads whole pages, so it reads the positions
    past prefix_len inside the last live page (and loads that page again
    into a last stage's surplus slots): masking gives them P = 0 exactly,
    so filling them with +-1e4 gives the bits of filling them with zeros.
    100 reruns give the same bits."""
    rng = np.random.default_rng(91)
    q, kp, vp, table, kt, vt, plen, tlen = _tc_prefill_inputs(rng, cuda, 32, 8, 128, ps,
                                                              "two_row_tiles")
    outs = []
    for value in (0.0, 1e4):
        k, v = kp.clone(), vp.clone()
        for bi, n in enumerate(plen.tolist()):
            if n % ps:
                page = int(table[bi, n // ps])
                k[:, page, n % ps:] = value
                v[:, page, n % ps:] = -value
        outs.append(pp.paged_flash_prefill(q, k, v, table, kt, vt, plen, tlen, window=window))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert bool(torch.isfinite(outs[1].float()).all())
    assert all(torch.equal(pp.paged_flash_prefill(q, k, v, table, kt, vt, plen, tlen,
                                                  window=window), outs[1])
               for _ in range(100))


def test_paged_prefill_page_sizes_and_routes(cuda):
    """bf16 pages of 24 rows (not a divisor of the 128-key stage) and of 4
    (not a multiple of 8) raise before any launch; float32 takes both, on
    the CUDA cores, within 2e-5. Every bf16 launch counts as
    ``paged_flash_prefill_tc``, no float32 one does."""
    rng = np.random.default_rng(92)
    for ps in (24, 4):
        args = _tc_prefill_inputs(rng, cuda, 8, 2, 64, ps, "ragged")
        kernels.reset_launch_counts()
        with pytest.raises(ValueError, match="page_size"):
            pp.paged_flash_prefill(*args)
        assert sum(kernels.launch_counts().values()) == 0
        args32 = [a.float() if a.is_floating_point() else a for a in args]
        o = pp.paged_flash_prefill(*args32)
        assert _prefill_routes(kernels.launch_counts(), torch.float32)
        torch.cuda.synchronize()
        assert _err(o, pp.paged_flash_prefill_plain(*args32)) < F32_TOL
    args = _tc_prefill_inputs(rng, cuda, 8, 2, 64, 16, "ragged")
    kernels.reset_launch_counts()
    for _ in range(3):
        pp.paged_flash_prefill(*args)
    pp.paged_flash_prefill(*(a.float() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["paged_flash_prefill"] == 4 and counts["paged_flash_prefill_tc"] == 3


# -- K3 / K4 -------------------------------------------------------------------


def _decode_inputs(rng, dev, dt, hq, hkv, d=128, ps=16, mp=20, b=5):
    """Rows of 0, 1, 50, 17 and mp * ps tokens over a scattered table."""
    num_pages = 1 + b * mp
    q = _randn(rng, (b, hq, d), dev, dt)
    kp, vp = (_randn(rng, (hkv, num_pages, ps, d), dev, dt) for _ in range(2))
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).reshape(b, mp)
                             .astype(np.int32)).to(dev)
    lengths = torch.tensor([0, 1, 50, 17, mp * ps], dtype=torch.int32, device=dev)
    return q, kp, vp, table, lengths


def _paged_routes(counts, dtype) -> bool:
    """Every K3/K4 launch went to the tensor-core kernel (bf16), or none did
    (float32)."""
    total = counts["paged_flash_decode"] + counts["paged_flash_decode_split"]
    tc = counts["paged_flash_decode_tc"] + counts["paged_flash_decode_split_tc"]
    return total > 0 and tc == (total if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("num_splits", [1, 2, 7])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 30.0)],
                         ids=["full", "window_softcap"])
def test_paged_decode_matches_plain(cuda, num_splits, dtype, hq, hkv, window, softcap):
    """Length-0 rows give exact zeros; rows of 1 and 17 tokens leave most
    splits empty, so the combine sees (0, -1e30, 0) states. bf16 runs on
    the tensor cores, float32 on the CUDA cores."""
    dt = DTYPES[dtype]
    args = _decode_inputs(np.random.default_rng(20 + num_splits), cuda, dt, hq, hkv)
    kernels.reset_launch_counts()
    o = pd.paged_flash_decode(*args, num_splits=num_splits, window=window, softcap=softcap)
    assert _paged_routes(kernels.launch_counts(), dt)
    o_ref = pd.paged_flash_decode_plain(*args, num_splits=num_splits, window=window,
                                        softcap=softcap)
    torch.cuda.synchronize()
    assert _close(o, o_ref)
    assert float(o[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("ps", [8, 16, 32, 64])
@pytest.mark.parametrize("num_splits", [1, 4, 7])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (25, 5, 64), (32, 1, 128)],
                         ids=["llama", "hymba", "group32"])
@pytest.mark.parametrize("window,softcap", [(None, None), (75, 30.0)],
                         ids=["full", "window_softcap"])
def test_paged_decode_tensor_cores_every_page_size(cuda, ps, num_splits, hq, hkv, d, window,
                                                   softcap):
    """The tensor-core kernel fills a 64-row stage with 64 / ps pages. Rows
    of 50 and 17 tokens leave their last stage fewer live pages than that
    at ps 8 and 16 (the surplus slots repeat the last live page, masked);
    window 75 starts mid-page on every row longer than it."""
    args = _decode_inputs(np.random.default_rng(70 + ps), cuda, torch.bfloat16, hq, hkv, d=d,
                          ps=ps, mp=1280 // ps)
    kw = dict(num_splits=num_splits, window=window, softcap=softcap)
    kernels.reset_launch_counts()
    o = pd.paged_flash_decode(*args, **kw)
    assert _paged_routes(kernels.launch_counts(), torch.bfloat16)
    o_ref = pd.paged_flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _close(o, o_ref)
    assert float(o[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_decode_ignores_rows_past_length(cuda, ps, window):
    """The tensor-core kernel loads whole pages, so it reads the rows past
    each length inside the row's last live page (and loads that page again
    into a last stage's surplus slots): masking gives them P = 0 exactly,
    so filling them with +-1e4 gives the bits of filling them with zeros.
    Ten reruns give the same bits."""
    rng = np.random.default_rng(72)
    q, kp, vp, table, lengths = _decode_inputs(rng, cuda, torch.bfloat16, 8, 2, ps=ps,
                                               mp=1280 // ps)
    lengths = torch.tensor([0, 1, 50, 17, 300], dtype=torch.int32, device=cuda)
    for ns in (1, 3):
        outs = []
        for value in (0.0, 1e4):
            k, v = kp.clone(), vp.clone()
            for bi, length in enumerate(lengths.tolist()):
                if length % ps:
                    page = int(table[bi, length // ps])
                    k[:, page, length % ps:] = value
                    v[:, page, length % ps:] = -value
            outs.append(pd.paged_flash_decode(q, k, v, table, lengths, window=window,
                                              num_splits=ns))
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        assert bool(torch.isfinite(outs[1].float()).all())
        assert all(torch.equal(pd.paged_flash_decode(q, k, v, table, lengths, window=window,
                                                     num_splits=ns), outs[1])
                   for _ in range(10))


def test_launch_counts_count_kernel_launches_only(cuda):
    rng = np.random.default_rng(30)
    args = _decode_inputs(rng, cuda, torch.bfloat16, 8, 2)
    kernels.reset_launch_counts()
    pd.paged_flash_decode_plain(*args, num_splits=3)
    pd.paged_flash_decode(*args, num_splits=1)
    pd.paged_flash_decode(*args, num_splits=3)
    pd.paged_flash_decode(*args, num_splits=3)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["paged_flash_decode"] == 1 and counts["paged_flash_decode_split"] == 2
    assert counts["paged_flash_decode_tc"] == 1 and counts["paged_flash_decode_split_tc"] == 2
    assert counts["flash_attention_fwd"] == 0 and counts["paged_flash_prefill"] == 0
    pd.paged_flash_decode(*(a.float() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["paged_flash_decode"] == 2 and counts["paged_flash_decode_tc"] == 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(31)
    q, kp, vp, table, lengths = _decode_inputs(rng, cuda, torch.float32, 8, 2)
    with pytest.raises(ValueError):                       # int64 lengths
        pd.paged_flash_decode(q, kp, vp, table, lengths.long())
    with pytest.raises(ValueError):                       # float16
        pd.paged_flash_decode(q.half(), kp.half(), vp.half(), table, lengths)
    with pytest.raises(ValueError):                       # lengths on the CPU
        pd.paged_flash_decode(q, kp, vp, table, lengths.cpu())
    with pytest.raises(ValueError, match="together"):      # one scale table alone
        pd.paged_flash_decode(q, kp, vp, table, lengths, k_scales=torch.ones(2, 101,
                                                                             device=cuda))
    # bf16 pages of 4 rows: the tensor-core stages need multiples of 8. It
    # raises; it does not go to the CUDA-core kernel.
    q4, kp4, vp4, table4, lengths4 = _decode_inputs(rng, cuda, torch.bfloat16, 8, 2, ps=4)
    kernels.reset_launch_counts()
    for ns in (1, 3):
        with pytest.raises(ValueError, match="multiple of 8"):
            pd.paged_flash_decode(q4, kp4, vp4, table4, lengths4, num_splits=ns)
    assert sum(kernels.launch_counts().values()) == 0
    q4, kp4, vp4 = q4.float(), kp4.float(), vp4.float()    # float32 takes pages of 4
    o = pd.paged_flash_decode(q4, kp4, vp4, table4, lengths4)
    assert _err(o, pd.paged_flash_decode_plain(q4, kp4, vp4, table4, lengths4)) < F32_TOL
    x = _randn(rng, (1, 4, 64, 32), cuda)
    with pytest.raises(ValueError):                       # head_dim 32
        fa.flash_attention_fwd(x, x, x)
    y = _randn(rng, (1, 4, 64, 128), cuda).transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):                       # not contiguous
        fa.flash_attention_fwd(y, y, y)


# -- K7 / K8: dense decode ---------------------------------------------------


def _dense_inputs(rng, dev, dt, hq, hkv, d, smax, b=6):
    q = _randn(rng, (b, hq, d), dev, dt)
    kc, vc = (_randn(rng, (b, hkv, smax, d), dev, dt) for _ in range(2))
    lengths = torch.tensor([0, 1, 37, smax // 2 + 3, smax - 5, smax][:b], dtype=torch.int32,
                           device=dev)
    return q, kc, vc, lengths


def _dense_routes(counts, dtype) -> bool:
    """Every K7/K8 launch went to the tensor-core kernel (bf16), or none did
    (float32)."""
    total = counts["flash_decode"] + counts["flash_decode_split"]
    tc = counts["flash_decode_tc"] + counts["flash_decode_split_tc"]
    return total > 0 and tc == (total if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("num_splits", [1, 2, 7])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(25, 5, 64), (32, 8, 128), (4, 1, 64), (32, 1, 128)],
                         ids=["hymba", "llama", "mqa", "group32"])
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 30.0), (8, None)],
                         ids=["full", "window_softcap", "window_lt_chunk"])
@pytest.mark.parametrize("smax,chunk", [(512, 64), (1000, 40)], ids=["c64", "c40"])
def test_dense_decode_matches_plain(cuda, num_splits, dtype, hq, hkv, d, window, softcap,
                                    smax, chunk):
    """bf16 runs on the tensor cores, float32 on the CUDA cores."""
    rng = np.random.default_rng(60)
    q, kc, vc, lengths = _dense_inputs(rng, cuda, DTYPES[dtype], hq, hkv, d, smax)
    kw = dict(window=window, softcap=softcap, chunk=chunk, num_splits=num_splits)
    kernels.reset_launch_counts()
    o = dd.flash_decode(q, kc, vc, lengths, **kw)
    assert _dense_routes(kernels.launch_counts(), DTYPES[dtype])
    ref = dd.flash_decode_plain(q, kc, vc, lengths, **kw)
    torch.cuda.synchronize()
    assert _close(o, ref)
    assert float(o[0].float().abs().max()) == 0.0


def test_dense_decode_reads_a_width_view(cuda):
    """The serving backend passes the stripes cut to the live width: a
    strided view gives the contiguous copy's output, one pass and split,
    on the tensor cores."""
    rng = np.random.default_rng(61)
    q, kc, vc, lengths = _dense_inputs(rng, cuda, torch.bfloat16, 25, 5, 64, 1024)
    lengths = torch.clamp(lengths, max=300)
    for ns in (1, 3):
        kernels.reset_launch_counts()
        o_view = dd.flash_decode(q, kc[:, :, :320], vc[:, :, :320], lengths, num_splits=ns)
        assert _dense_routes(kernels.launch_counts(), torch.bfloat16)
        o_copy = dd.flash_decode(q, kc[:, :, :320].contiguous(), vc[:, :, :320].contiguous(),
                                 lengths, num_splits=ns)
        torch.cuda.synchronize()
        assert torch.equal(o_view, o_copy)


@pytest.mark.parametrize("window", [None, 40])
def test_dense_decode_ignores_rows_past_length(cuda, window):
    """The tensor-core kernel loads whole 64-row tiles of the view, so it
    reads the rows past each length (stale rows of an earlier request, pad
    rows of a right-padded prefill): masking gives them P = 0 exactly, so
    filling them with +-1e4 gives the bits of filling them with zeros."""
    rng = np.random.default_rng(63)
    q, kc, vc, lengths = _dense_inputs(rng, cuda, torch.bfloat16, 25, 5, 64, 1024)
    lengths = torch.clamp(lengths, max=300)
    past = (torch.arange(320, device=cuda)[None, None, :, None]
            >= lengths.long()[:, None, None, None])
    sign = torch.from_numpy(np.sign(rng.standard_normal((6, 5, 320, 64)))).to(cuda)
    fill = (1e4 * sign).to(torch.bfloat16)
    for ns in (1, 3):
        outs = []
        for value in (torch.zeros_like(fill), fill):
            k, v = kc.clone(), vc.clone()
            k[:, :, :320] = torch.where(past, value, k[:, :, :320])
            v[:, :, :320] = torch.where(past, -value, v[:, :, :320])
            outs.append(dd.flash_decode(q, k[:, :, :320], v[:, :, :320], lengths,
                                        window=window, num_splits=ns))
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        assert bool(torch.isfinite(outs[1].float()).all())


def test_dense_decode_refuses_misaligned_or_strided_caches(cuda):
    """The bf16 kernel's tensor maps need a 16-byte aligned start and batch
    and head strides of whole 16 bytes (8 elements); a cache that breaks
    either raises before launching, as does one whose rows are not
    contiguous."""
    rng = np.random.default_rng(64)
    q, kc, vc, lengths = _dense_inputs(rng, cuda, torch.bfloat16, 8, 2, 64, 128)
    n = kc.numel()
    flat = torch.zeros(n + 64, device=cuda, dtype=torch.bfloat16)
    off = flat[1:n + 1].view(kc.shape)                       # starts 2 bytes off
    assert off.data_ptr() % 16
    odd = torch.as_strided(flat, kc.shape, (2 * 128 * 64 + 4, 128 * 64 + 2, 64, 1))
    rows = kc.transpose(2, 3).contiguous().transpose(2, 3)    # rows not contiguous
    kernels.reset_launch_counts()
    for bad in (off, odd, rows):
        with pytest.raises(ValueError):
            dd.flash_decode(q, bad, bad, lengths)
        with pytest.raises(ValueError):
            dd.flash_decode(q, bad, bad, lengths, num_splits=2)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("smax", [100, 700, 1000])
def test_ops_decode_attention_pads_odd_capacities(cuda, smax):
    rng = np.random.default_rng(62)
    q, kc, vc, lengths = _dense_inputs(rng, cuda, torch.float32, 8, 2, 64, smax)
    o = ops.decode_attention(q, kc, vc, lengths)
    ref = dd.flash_decode_plain(q, kc, vc, lengths, chunk=smax)
    torch.cuda.synchronize()
    assert _close(o, ref)


# -- K9: SSD intra-chunk -----------------------------------------------------


def _slice_rel(a, ref) -> float:
    diff = (a - ref).abs().flatten(-2).amax(-1)
    den = ref.abs().flatten(-2).amax(-1).clamp_min(1e-30)
    return float((diff / den).max())


def _ssd_inputs(rng, dev, b, l, h, p, g, n):
    x = _randn(rng, (b, l, h, p), dev)
    dt = torch.nn.functional.softplus(_randn(rng, (b, l, h), dev))
    a = -torch.exp(_randn(rng, (h,), dev) * 0.5)
    bm, cm = _randn(rng, (b, l, g, n), dev), _randn(rng, (b, l, g, n), dev)
    return x, dt, a, bm, cm


def _ssd_seq_inputs(rng, dev, b, nc, q, h, p, g, n, layout):
    """K9's inputs in the layout ``ssd_chunked_cuda`` passes: xdt (B,nc,q,H,P),
    acum (B,nc,q,H), and B / C (B,nc,q,G,N) as slices of one wider row, at
    a 16-byte-aligned offset (read in place) or, for ``misaligned``, one
    float off (the wrapper copies them first)."""
    xdt = _randn(rng, (b, nc, q, h, p), dev)
    off = 1 if layout == "misaligned" else 4
    wide = _randn(rng, (2, b, nc, q, g, n + 8), dev)
    bq, cq = wide[0, ..., off:off + n], wide[1, ..., off:off + n]
    dta = -torch.nn.functional.softplus(_randn(rng, (b, nc, q, h), dev)) * 0.5
    return xdt, bq, cq, torch.cumsum(dta, dim=2)


def _ssd_check_seq(xdt, bq, cq, acum):
    """K9 on the sequence-major entry against the plain version on the
    per-head JAX layout, per slice."""
    perm = (0, 1, 3, 2, 4)
    y, s = ssd_kernel.ssd_intra_chunk_seq(xdt, bq, cq, acum)
    y_ref, s_ref = ssd_kernel.ssd_intra_chunk_plain(xdt.permute(perm), bq.permute(perm),
                                                    cq.permute(perm), acum.permute(0, 1, 3, 2))
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert _slice_rel(y.permute(perm), y_ref) <= SSD_TOL
    assert _slice_rel(s.transpose(-1, -2), s_ref) <= SSD_TOL
    return y, s


@pytest.mark.parametrize("layout", ["per_head", "g1", "g2", "misaligned"])
@pytest.mark.parametrize("n,p", ssd_kernel.SHAPES)
@pytest.mark.parametrize("q", [300, 256, 200, 100, 32])
def test_ssd_intra_chunk_matches_plain(cuda, n, p, q, layout):
    """Per head in the JAX layout, as the JAX function takes it; and in the
    layout ``ssd_chunked_cuda`` passes, B and C per group (G 1 and 2 over H
    4) read in place through their strides, or copied when misaligned.
    Chunks of any length: 300 takes three query tiles, 100 is a prompt
    shorter than the chunk."""
    rng = np.random.default_rng(63)
    b, nc, h = 2, 3, 4
    if layout != "per_head":
        g = 2 if layout == "g2" else 1
        _ssd_check_seq(*_ssd_seq_inputs(rng, cuda, b, nc, q, h, p, g, n, layout))
        return
    xdt = _randn(rng, (b, nc, h, q, p), cuda)
    bh, ch = _randn(rng, (b, nc, h, q, n), cuda), _randn(rng, (b, nc, h, q, n), cuda)
    dta = -torch.nn.functional.softplus(_randn(rng, (b, nc, h, q), cuda)) * 0.5
    acum = torch.cumsum(dta, dim=-1).contiguous()
    y, s = ssd_kernel.ssd_intra_chunk(xdt, bh, ch, acum)
    y_ref, s_ref = ssd_kernel.ssd_intra_chunk_plain(xdt, bh, ch, acum)
    torch.cuda.synchronize()
    assert _slice_rel(y, y_ref) <= SSD_TOL
    assert _slice_rel(s, s_ref) <= SSD_TOL


@pytest.mark.parametrize("n,p", [(16, 64), (128, 64)])
def test_ssd_intra_chunk_masks_before_exp(cuda, n, p):
    """acum spanning -60..0 and -100..0 over a chunk: above the diagonal seg
    reaches +100, where exp overflows float32; masked in log space first,
    every output is finite and within SSD_TOL of the plain version."""
    rng = np.random.default_rng(66)
    b, nc, q, h = 1, 2, 256, 2
    xdt, bq, cq, _ = _ssd_seq_inputs(rng, cuda, b, nc, q, h, p, 1, n, "g1")
    steps = torch.from_numpy(rng.exponential(1.0, (b, nc, q, h)).astype(np.float32)).to(cuda)
    acum = -torch.cumsum(steps, 2) / steps.sum(2, keepdim=True)
    acum = acum * torch.tensor([60.0, 100.0], device=cuda)
    _ssd_check_seq(xdt, bq, cq, acum)


def test_ssd_intra_chunk_reruns_are_bitwise_equal(cuda):
    """No atomics: 100 reruns at mamba2's widths give the same bits."""
    rng = np.random.default_rng(67)
    args = _ssd_seq_inputs(rng, cuda, 1, 4, 256, 4, 64, 1, 128, "g1")
    y, s = _ssd_check_seq(*args)
    differ = 0
    for _ in range(100):
        y2, s2 = ssd_kernel.ssd_intra_chunk_seq(*args)
        differ += not (torch.equal(y, y2) and torch.equal(s, s2))
    assert differ == 0


@pytest.mark.parametrize("n,p", ssd_kernel.SHAPES)
def test_ssd_function_runs_k9_forward_and_the_written_out_backward(cuda, n, p):
    """``ssd.SSDIntraChunk`` on the card: K9 forward (one launch) within
    SSD_TOL per slice of the plain version, and the written-out backward
    (float32, TF32 off) within 2e-5 of each gradient's max of autograd of
    the plain version in float64, at each instantiated (N, P); B and C per
    group (G 2 over H 4) as slices of one wider row, acum spanning 100 over
    a chunk (exp above the diagonal overflows float32)."""
    rng = np.random.default_rng(68)
    b, nc, q, h, g = 1, 2, 256, 4, 2
    xdt, bq, cq, _ = _ssd_seq_inputs(rng, cuda, b, nc, q, h, p, g, n, "g2")
    steps = torch.from_numpy(rng.exponential(1.0, (b, nc, q, h)).astype(np.float32)).to(cuda)
    acum = -torch.cumsum(steps, 2) / steps.sum(2, keepdim=True) * 100.0
    dy = _randn(rng, (b, nc, q, h, p), cuda)
    ds = _randn(rng, (b, nc, h, p, n), cuda)
    ins = [t.detach().requires_grad_(True) for t in (xdt, bq, cq, acum)]
    kernels.reset_launch_counts()
    y, s = ssd_kernel.SSDIntraChunk.apply(*ins)
    torch.autograd.backward((y, s), (dy, ds))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_intra_chunk_tc"] == 1
    perm = (0, 1, 3, 2, 4)
    ref = [t.detach().double().requires_grad_(True) for t in (xdt, bq, cq, acum)]
    y_r, s_r = ssd_kernel.ssd_intra_chunk_plain(ref[0].permute(perm), ref[1].permute(perm),
                                                ref[2].permute(perm), ref[3].permute(0, 1, 3, 2))
    torch.autograd.backward((y_r.permute(perm), s_r.transpose(-1, -2)),
                            (dy.double(), ds.double()))
    assert _slice_rel(y.permute(perm).double(), y_r) <= SSD_TOL
    assert _slice_rel(s.transpose(-1, -2).double(), s_r) <= SSD_TOL
    for name, t, r in zip(("xdt", "bq", "cq", "acum"), ins, ref):
        assert torch.isfinite(t.grad).all(), name
        err = float((t.grad.double() - r.grad).abs().max())
        assert err <= 2e-5 * float(r.grad.abs().max()), name


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_train_grads_on_kernels_match_plain(cuda, arch, seed):
    """mamba2-1.3b and hymba-1.5b at full width, 2 layers, bf16 compute,
    sequence 1024, weights and batch of ``seed`` (1 is ``chip_smoke.py``'s):
    one step's gradients through K9 (forward, the written-out backward) and,
    for hymba, K1 / K5 / K6, against the same step on the plain versions
    (``attn_impl`` and ``ssm.impl`` "plain") and on the plain versions in
    float32 compute. As ``chip_smoke.py``'s ``check_train_grads`` holds
    them: the loss within 1e-2 relative of the plain path's
    (``TRAIN_LOSS_TOL``), each leaf by its relative norm within 1e-2
    (``TRAIN_GRAD_TOL``): mamba2's distance from the plain path; hymba's
    distance from float32 past the plain path's own, since hymba's SSM
    vectors behind the output norms (``dt_bias``, ``a_log``) move by about
    that bar between any two bf16 paths (``PERF.md`` section 6). Remat: K9
    and K1 twice per layer, K5 / K6 once."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, make_pipeline

    full = {"mamba2-1.3b": mamba2_1_3b.CONFIG, "hymba-1.5b": hymba_1_5b.CONFIG}[arch]
    cfg = dataclasses.replace(full, n_layers=2)
    plain = dataclasses.replace(cfg, attn_impl="plain",
                                ssm=dataclasses.replace(cfg.ssm, impl="plain"))
    runs = {"auto": cfg, "plain": plain,
            "float32": dataclasses.replace(plain, compute_dtype="float32")}
    batch = ts.to_device(make_pipeline(DataConfig(seq_len=1024, global_batch=1, seed=seed,
                                                  vocab=cfg.vocab)).batch_at(0), cuda)
    params = transformer.init_model(cfg, seed=seed, device=cuda, param_dtype=torch.float32)
    grads, losses = {}, {}
    for impl, c in runs.items():
        kernels.reset_launch_counts()
        g, loss, _ = ts._accumulate_grads(params, c, batch, ts.TrainConfig())
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        grads[impl] = {tree_lib.key_of(p): t.clone() for p, t in tree_lib.leaves_with_paths(g)}
        losses[impl] = float(loss)
        if impl == "auto":
            attn = 2 if arch == "hymba-1.5b" else 0
            assert counts["ssd_intra_chunk_tc"] == 2 * 2
            assert counts["flash_attention_fwd_tc"] == 2 * attn
            assert counts["flash_attention_bwd_dq_tc"] == attn
            assert counts["flash_attention_bwd_dkv_tc"] == attn
        else:
            assert sum(counts.values()) == 0
    assert abs(losses["auto"] - losses["plain"]) <= 1e-2 * abs(losses["plain"])

    def rel(a, b):
        return {k: float((grads[a][k] - r).norm() / r.norm()) for k, r in grads[b].items()}

    if arch == "hymba-1.5b":
        own, ref = rel("auto", "float32"), rel("plain", "float32")
        held = {k: own[k] - ref[k] for k in own}
    else:
        held = rel("auto", "plain")
    for path, g in grads["auto"].items():
        assert torch.isfinite(g).all(), path
        assert held[path] <= 1e-2, path


@pytest.mark.parametrize("view", ["contiguous", "xbc_slices"])
@pytest.mark.parametrize("l,n,p,g", [(512, 16, 64, 1), (300, 128, 64, 1), (256, 16, 128, 2)])
def test_ssd_chunked_cuda_matches_plain_and_hands_off_state(cuda, l, n, p, g, view):
    """The scan on K9 against the plain scan, and the state handed from one
    half to the next; B and C either contiguous or, as the SSM block passes
    them, slices of one projection row (bf16 there; float32 here)."""
    rng = np.random.default_rng(64)
    x, dt, a, bm, cm = _ssd_inputs(rng, cuda, 2, l, 4, p, g, n)
    if view == "xbc_slices":
        xbc = _randn(rng, (2, l, 8 + 2 * g * n), cuda)
        xbc[..., 8:8 + g * n] = bm.reshape(2, l, g * n)
        xbc[..., 8 + g * n:] = cm.reshape(2, l, g * n)
        bm = xbc[..., 8:8 + g * n].reshape(2, l, g, n)
        cm = xbc[..., 8 + g * n:].reshape(2, l, g, n)
        assert not bm.is_contiguous()
    y, hT = ssd_kernel.ssd_chunked_cuda(x, dt, a, bm, cm, 128)
    y_ref, h_ref = ssm.ssd_chunked(x, dt, a, bm, cm, 128)
    torch.cuda.synchronize()
    scale = float(y_ref.abs().max())
    assert float((y - y_ref).abs().max()) <= SSD_TOL * 10 * scale
    assert float((hT - h_ref).abs().max()) <= SSD_TOL * 10 * float(h_ref.abs().max())
    half = 128
    y1, h1 = ssd_kernel.ssd_chunked_cuda(x[:, :half], dt[:, :half], a, bm[:, :half],
                                         cm[:, :half], 128)
    y2, h2 = ssd_kernel.ssd_chunked_cuda(x[:, half:], dt[:, half:], a, bm[:, half:],
                                         cm[:, half:], 128, h0=h1)
    torch.cuda.synchronize()
    assert float((torch.cat([y1, y2], 1) - y_ref).abs().max()) <= SSD_TOL * 10 * scale
    assert float((h2 - h_ref).abs().max()) <= SSD_TOL * 10 * float(h_ref.abs().max())


def test_new_kernels_count_and_refuse_grad(cuda):
    rng = np.random.default_rng(65)
    q, kc, vc, lengths = _dense_inputs(rng, cuda, torch.bfloat16, 8, 2, 64, 512)
    xdt = _randn(rng, (1, 2, 2, 64, 64), cuda)
    bh = _randn(rng, (1, 2, 2, 64, 16), cuda)
    acum = torch.cumsum(-torch.rand((1, 2, 2, 64), device=cuda), -1).contiguous()
    kernels.reset_launch_counts()
    dd.flash_decode_plain(q, kc, vc, lengths, num_splits=3)
    ssd_kernel.ssd_intra_chunk_plain(xdt, bh, bh, acum)
    dd.flash_decode(q, kc, vc, lengths)
    dd.flash_decode(q, kc, vc, lengths, num_splits=3)
    ssd_kernel.ssd_intra_chunk(xdt, bh, bh, acum)
    perm = (0, 1, 3, 2, 4)
    ssd_kernel.ssd_intra_chunk_seq(xdt.permute(perm), bh[:, :, :1].permute(perm),
                                   bh[:, :, :1].permute(perm), acum.permute(0, 1, 3, 2))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_decode"] == 1 and counts["flash_decode_split"] == 1
    assert counts["flash_decode_tc"] == 1 and counts["flash_decode_split_tc"] == 1
    assert counts["ssd_intra_chunk_tc"] == 2
    with pytest.raises(RuntimeError, match="flash_decode"):
        dd.flash_decode(q.requires_grad_(True), kc, vc, lengths)
    with pytest.raises(RuntimeError, match="ssd_intra_chunk"):
        ssd_kernel.ssd_intra_chunk(xdt.requires_grad_(True), bh, bh, acum)
    with pytest.raises(ValueError):                       # (N, P) = (16, 32)
        ssd_kernel.ssd_intra_chunk(xdt[..., :32].contiguous(), bh, bh, acum)
    with pytest.raises(ValueError):                       # Smax not a chunk multiple
        dd.flash_decode(q.detach(), kc, vc, lengths, chunk=48)


# -- the engine on the kernels -------------------------------------------------


def test_engine_on_kernels_matches_engine_on_plain_versions(cuda):
    """SMOKE widened to head_dim 64 (the kernels take 64 and 128), float32:
    the kernel engine gives the plain engine's greedy ids, with prefix
    sharing, and goes through K1, K2 and the decode kernels."""
    cfg = dataclasses.replace(llama3_8b.SMOKE, head_dim=64)
    params = transformer.init_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(40)
    system = rng.integers(1, cfg.vocab, size=(48,))
    prompts = [np.concatenate([system, rng.integers(1, cfg.vocab, size=(n,))])
               for n in (5, 30, 12)]
    kw = dict(num_pages=64, page_size=16, max_batch=3, max_pages_per_seq=10,
              prompt_buckets=(16, 32, 64, 128), device=cuda)
    tokens = {}
    for impl in ("auto", "plain"):
        eng = LLMEngine(dataclasses.replace(cfg, attn_impl=impl), params, **kw)
        kernels.reset_launch_counts()
        out = eng.generate([Request(uid=i, prompt=p, max_new_tokens=12)
                            for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        tokens[impl] = {o.uid: [int(t) for t in o.tokens] for o in out}
        eng.close()
        if impl == "auto":
            assert counts["flash_attention_fwd"] > 0 and counts["paged_flash_prefill"] > 0
            assert counts["paged_flash_decode"] + counts["paged_flash_decode_split"] > 0
        else:
            assert sum(counts.values()) == 0
    assert tokens["auto"] == tokens["plain"]


def test_dense_engine_on_kernels_matches_plain_hymba(cuda):
    """hymba SMOKE widened to attention head_dim 64 and SSM head 64 / state
    16 (shapes the kernels take), float32: the dense engine on K1, K7/K8
    and K9 gives the plain engine's greedy ids, prompts off the buckets."""
    cfg = dataclasses.replace(hymba_1_5b.SMOKE, head_dim=64,
                              ssm=dataclasses.replace(hymba_1_5b.SMOKE.ssm, head_dim=64,
                                                      state_dim=16))
    params = transformer.init_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, cfg.vocab, size=(n,)) for n in (20, 90, 45, 130)]
    kw = dict(max_batch=3, cache_len=256, prompt_buckets=(32, 64, 128, 192), device=cuda)
    tokens = {}
    for impl in ("auto", "plain"):
        c = dataclasses.replace(cfg, attn_impl=impl,
                                ssm=dataclasses.replace(cfg.ssm, impl=impl))
        eng = LLMEngine(c, params, **kw)
        assert eng.kv_layout == "dense"
        kernels.reset_launch_counts()
        out = eng.generate([Request(uid=i, prompt=p, max_new_tokens=10)
                            for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        tokens[impl] = {o.uid: [int(t) for t in o.tokens] for o in out}
        if impl == "auto":
            assert counts["flash_attention_fwd"] > 0 and counts["ssd_intra_chunk_tc"] > 0
            assert counts["flash_decode"] + counts["flash_decode_split"] > 0
        else:
            assert sum(counts.values()) == 0
    assert tokens["auto"] == tokens["plain"]


def test_train_step_on_kernels_matches_plain_path(cuda):
    """SMOKE widened to head_dim 64, float32: one train step's gradients
    through K1/K5/K6 against the same step on the plain versions, from the
    same weights and batch; and the step went through the kernels."""
    cfg = dataclasses.replace(llama3_8b.SMOKE, head_dim=64)
    tcfg = ts.TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                          microbatches=2)
    from repro_torch.data.pipeline import DataConfig, make_pipeline

    batch = ts.to_device(make_pipeline(DataConfig(seq_len=100, global_batch=4,
                                                  vocab=cfg.vocab)).batch_at(0), cuda)
    grads, losses = {}, {}
    for impl in ("auto", "plain"):
        params = transformer.init_model(cfg, seed=0, device=cuda, param_dtype=torch.float32)
        kernels.reset_launch_counts()
        g, loss, _ = ts._accumulate_grads(params, dataclasses.replace(cfg, attn_impl=impl),
                                          batch, tcfg)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        grads[impl], losses[impl] = g, float(loss)
        if impl == "auto":
            # remat: K1 twice per layer per microbatch; K5 / K6 once.
            assert counts["flash_attention_fwd"] == 2 * cfg.n_layers * 2
            assert counts["flash_attention_bwd_dq"] == cfg.n_layers * 2
            assert counts["flash_attention_bwd_dkv"] == cfg.n_layers * 2
        else:
            assert sum(counts.values()) == 0
    assert abs(losses["auto"] - losses["plain"]) <= 1e-5 * abs(losses["plain"])
    from repro_torch.core import tree as tree_lib

    for (path, a), b in zip(tree_lib.leaves_with_paths(grads["auto"]),
                            tree_lib.leaves(grads["plain"])):
        assert float((a - b).norm() / b.norm()) <= 1e-4, path



@pytest.mark.parametrize("arch", ["llama3-8b", "hymba-1.5b"])
def test_train_f32_full_width_on_kernels_matches_plain(cuda, arch):
    """A float32 train step at full width, 2 layers, sequence 1024 (as
    ``chip_smoke.py``'s ``check_train_f32``): llama3-8b (D 128, GQA 32 / 8)
    and hymba-1.5b (D 64, GQA 25 / 5, a window-1024 layer, K9 beside the
    attention) on the kernels, K1 in float32 twice a layer (remat) and K5 /
    K6 once on the 3xTF32 kernels, against the plain float32 path: the loss
    within 1e-2 relative (``TRAIN_LOSS_TOL``), each gradient leaf's
    relative norm within 1e-4 (``FP32_TRAIN_GRAD_TOL``)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, make_pipeline

    full = {"llama3-8b": llama3_8b.CONFIG, "hymba-1.5b": hymba_1_5b.CONFIG}[arch]
    cfg = dataclasses.replace(full, n_layers=2, compute_dtype="float32")
    plain = dataclasses.replace(cfg, attn_impl="plain")
    if cfg.ssm is not None:
        plain = dataclasses.replace(plain, ssm=dataclasses.replace(cfg.ssm, impl="plain"))
    batch = ts.to_device(make_pipeline(DataConfig(seq_len=1024, global_batch=1, seed=1,
                                                  vocab=cfg.vocab)).batch_at(0), cuda)
    params = transformer.init_model(cfg, seed=1, device=cuda, param_dtype=torch.float32)
    grads, losses = {}, {}
    for impl, c in (("auto", cfg), ("plain", plain)):
        kernels.reset_launch_counts()
        g, loss, _ = ts._accumulate_grads(params, c, batch, ts.TrainConfig())
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        grads[impl] = {tree_lib.key_of(p): t.clone() for p, t in tree_lib.leaves_with_paths(g)}
        losses[impl] = float(loss)
        if impl == "auto":
            assert counts["flash_attention_fwd"] == 2 * 2
            assert counts["flash_attention_fwd_tc"] == 0
            assert _bwd_routes(counts, torch.float32, n=2), counts
            assert counts["ssd_intra_chunk_tc"] == (2 * 2 if cfg.ssm is not None else 0)
        else:
            assert sum(counts.values()) == 0
    assert abs(losses["auto"] - losses["plain"]) <= 1e-2 * abs(losses["plain"])
    for path, r in grads["plain"].items():
        g = grads["auto"][path]
        assert torch.isfinite(g).all(), path
        assert float((g - r).norm() / r.norm()) <= 1e-4, path

# -- the fused decode as CUDA graphs --------------------------------------------


def _graph_cfg():
    """SMOKE widened to head_dim 64 in bf16: every decode tick runs on the
    tensor-core kernels (K3/K4 paged, K7/K8 dense)."""
    return dataclasses.replace(llama3_8b.SMOKE, head_dim=64, compute_dtype="bfloat16")


_GRAPH_KW = {"paged": dict(kv_layout="paged", num_pages=64, page_size=16, max_batch=3,
                           max_pages_per_seq=8, prompt_buckets=(16, 32, 64)),
             "dense": dict(kv_layout="dense", max_batch=3, cache_len=128,
                           prompt_buckets=(32, 64))}


def _graph_requests(cfg, seed=50, max_tokens=17):
    from repro_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab, size=(n,)) for n in (9, 21, 40)]
    return [Request(uid=0, prompt=prompts[0], max_new_tokens=max_tokens),
            Request(uid=1, prompt=prompts[1],
                    sampling=SamplingParams(temperature=0.8, top_k=30, top_p=0.9,
                                            max_tokens=max_tokens, seed=4)),
            Request(uid=2, prompt=prompts[2], max_new_tokens=max_tokens)]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_fused_graphs_one_tick_equals_eight_ticks_bitwise(cuda, layout):
    """steps_per_sync 1 replays a one-tick graph of the tick function that
    the 8-tick graph repeats: the same ids, and the logits of tick 8 with the
    same bits. Each sync is one graph replay."""
    cfg = _graph_cfg()
    params = transformer.init_model(cfg, seed=0, device=cuda)
    ids, logits = {}, {}
    for n in (1, 8):
        eng = LLMEngine(cfg, params, steps_per_sync=n, device=cuda, **_GRAPH_KW[layout])
        for r in _graph_requests(cfg):
            eng.add_request(r)
        seen, out = [], {}
        while eng.backend.active.any() or eng.scheduler.has_work():
            out.update({o.uid: o for o in eng.step() if o.finished})
            seen.append(eng.backend.last_logits.clone())
        ids[n] = {u: [int(t) for t in o.tokens] for u, o in out.items()}
        logits[n] = seen
        assert all(p.graph is not None for p in eng.backend._programs.values())
        eng.close()
    assert ids[1] == ids[8]
    assert all(len(t) == 17 for t in ids[8].values())
    # The 8-tick sync's last tick is the one-tick engine's eighth sync.
    assert torch.equal(logits[8][0], logits[1][7])
    assert torch.isfinite(logits[8][0]).all()


# Logits of the bf16 graph engine against the plain engine, relative to the
# plain path's max |logit|: bf16 attention outputs round differently in the
# two paths, as ``chip_smoke.py``'s LOGIT_TOL holds them at full width.
LOGIT_TOL = 5e-2


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_fused_graph_engine_matches_the_plain_engine_in_bf16(cuda, layout):
    """bf16, steps_per_sync 1, in lockstep: each sync of the graph engine
    (the tensor-core decode kernels) against the same sync of the plain
    engine (attention impl "plain", its tick a captured graph too), the
    same weights and greedy requests that finish at 3, 9 and 17 tokens (so
    later syncs run rows that are free, on the null page or at length 0).
    Every live row's last-tick logits lie within LOGIT_TOL of the plain
    path's max |logit|, and its tokens so far are the plain path's; a row
    whose ids part is followed no further, and may part only where the
    plain logits' margin is within twice the row's error."""
    _lockstep_against_plain(cuda, _GRAPH_KW[layout])


def test_fused_graph_engine_matches_the_plain_engine_int8(cuda):
    """The same lockstep over an int8 pool: the graph engine's decode runs
    the quantized K3 (K2q on the extend waves), the plain engine the plain
    versions over the same codes and scales; frozen rows append to the
    null page in both."""
    counts = _lockstep_against_plain(cuda, dict(_GRAPH_KW["paged"], kv_dtype="int8"))
    assert counts["paged_flash_decode_q"] + counts["paged_flash_decode_split_q"] > 0
    assert counts["paged_flash_decode"] + counts["paged_flash_decode_split"] == 0


def _lockstep_against_plain(cuda, engine_kw):
    """The body of the lockstep tests on an engine of ``engine_kw``;
    returns the launch counts of the run."""
    cfg = _graph_cfg()
    params = transformer.init_model(cfg, seed=0, device=cuda)
    layout = engine_kw["kv_layout"]
    kernels.reset_launch_counts()
    prompts = [np.random.default_rng(54).integers(1, cfg.vocab, size=(n,))
               for n in (9, 21, 40)]
    engines, first = {}, {}
    for impl in ("auto", "plain"):
        eng = LLMEngine(dataclasses.replace(cfg, attn_impl=impl), params, steps_per_sync=1,
                        device=cuda, **engine_kw)
        assert eng.kv_layout == layout
        b, kept = eng.backend, first.setdefault(impl, {})

        def recording(records, b=b, flush=b.flush, kept=kept):
            got = flush(records)
            kept.update({b.row_req(r).uid: x.float() for r, x in got.items()})
            return got

        b.flush = recording                 # keeps each request's prefill logits
        for i, (p, m) in enumerate(zip(prompts, (3, 9, 17))):
            eng.add_request(Request(uid=i, prompt=p, max_new_tokens=m))
        engines[impl] = eng
    compared, parted = 0, set()
    while engines["plain"].backend.active.any() or engines["plain"].scheduler.has_work():
        seen = {}
        for impl, eng in engines.items():
            eng.step()
            b = eng.backend
            seen[impl] = {b.row_req(r).uid: (b.last_logits[r].float(),
                                             [int(t) for t in b.out[r]] + [eng._pending[r]])
                          for r in range(b.rows) if b.active[r]}
        assert sorted(seen["auto"]) == sorted(seen["plain"])
        for uid, (ref, ref_ids) in seen["plain"].items():
            got, ids = seen["auto"][uid]
            if uid in parted:
                continue
            if ids[:1] != ref_ids[:1]:
                # The first token comes from the prefill's logits.
                ref, got = first["plain"][uid], first["auto"][uid]
                ids, ref_ids = ids[:1], ref_ids[:1]
            else:
                assert ids[:-1] == ref_ids[:-1], uid
                compared += 1
            assert torch.isfinite(got).all()
            diff = float((got - ref).abs().max())
            assert diff <= LOGIT_TOL * float(ref.abs().max()), (uid, diff)
            if ids != ref_ids:
                i, j = ref_ids[-1], ids[-1]
                assert float(ref[i] - ref[j]) <= 2 * diff, uid
                parted.add(uid)
    # 26 row-syncs in all (a row is live after m - 1 of them).
    assert len(parted) <= 1 and compared >= 10
    assert all(p.graph is not None for e in engines.values()
               for p in e.backend._programs.values())
    for eng in engines.values():
        eng.close()
    return kernels.launch_counts()


def test_fused_graph_captures_flat_and_replays_count_launches(cuda):
    """After the first wave captures its graphs, later waves capture none;
    a replay adds the launches its capture recorded, so launch_counts()
    still counts launches on the card: 4 ticks x layers decode launches a
    sync, all on the tensor cores."""
    cfg = _graph_cfg()
    params = transformer.init_model(cfg, seed=0, device=cuda)
    eng = LLMEngine(cfg, params, steps_per_sync=4, device=cuda, **_GRAPH_KW["paged"])
    eng.generate(_graph_requests(cfg, seed=51, max_tokens=9))
    warm = eng.backend.stats["decode_traces"]
    assert warm >= 1
    eng.generate(_graph_requests(cfg, seed=52, max_tokens=9))
    assert eng.backend.stats["decode_traces"] == warm
    for r in _graph_requests(cfg, seed=53, max_tokens=9):
        eng.add_request(r)
    eng.step()                          # admission, prefill, the first sync
    kernels.reset_launch_counts()
    eng.step()                          # one sync: one replay of 4 ticks
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    decode = counts["paged_flash_decode"] + counts["paged_flash_decode_split"]
    assert decode == 4 * cfg.n_layers
    assert counts["paged_flash_decode_tc"] + counts["paged_flash_decode_split_tc"] == decode
    assert counts["flash_attention_fwd"] == counts["paged_flash_prefill"] == 0
    assert eng.backend.stats["decode_traces"] == warm
    eng.generate([])
    eng.close()


_FAILED_CAPTURE = """
import dataclasses, sys
import numpy as np
import torch
from repro_torch.configs import llama3_8b
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request
from repro_torch.serving import sampling

cfg = dataclasses.replace(llama3_8b.SMOKE, head_dim=64, compute_dtype="bfloat16")
params = transformer.init_model(cfg, seed=0, device="cuda")
eng = LLMEngine(cfg, params, steps_per_sync=2, num_pages=32, max_batch=2,
                max_pages_per_seq=4, prompt_buckets=(16, 32), device="cuda")
plain = sampling.sample_batch

def syncing(logits, *args):
    int(logits.argmax())                 # a host read inside the tick
    return plain(logits, *args)

sampling.sample_batch = syncing
try:
    eng.generate([Request(uid=0, prompt=np.arange(1, 12), max_new_tokens=4)])
except RuntimeError:
    print("raised", eng.backend.stats["decode_traces"], len(eng.backend.out[0]))
    sys.exit(0)
print("no error")
"""


def test_a_failed_capture_raises_with_no_eager_fallback(cuda, tmp_path):
    """A tick that reads the device from the host cannot be captured: the
    engine raises instead of decoding eagerly (run in a child process, so
    the aborted capture leaves this one clean)."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["raised", "1", "0"], out.stdout


# -- K2 / K3 / K4 over quantized pools -------------------------------------------

CODES = ["int8", "fp8"]


def _quantized(rng, dev, hkv, num_pages, ps, d, kv_dtype):
    """A quantized K and V pool made on the card from normal values, and
    the null page (0) overwritten as rows frozen on it leave it: codes
    that are NaN bits in e4m3 (0x7F) or extreme in int8, and NaN scales."""
    from repro_torch.cache import quant

    pools = []
    for _ in range(2):
        codes, scales = quant.quantize_pages(
            _randn(rng, (hkv, num_pages, ps, d), dev), kv_dtype)
        codes.view(torch.uint8)[:, 0] = 0x7F
        scales[:, 0] = float("nan")
        pools += [codes, scales]
    return pools


def _serve_decode_inputs(rng, dev, dt, kv_dtype, mp=36, lengths=(560, 0, 300, 17, 576, 1,
                                                                      560, 560)):
    """llama3-8b's decode at the serve run's shape (8 rows, 36-page table,
    pages of 16): scattered tables padded with the null page, a length-0
    row, and rows 6 and 7 frozen on the null page (table all 0, length
    kept, as the fused decode leaves a finished row)."""
    b, hq, hkv, d, ps = len(lengths), 32, 8, 128, 16
    num_pages = 1 + b * mp
    kc, ks, vc, vs = _quantized(rng, dev, hkv, num_pages, ps, d, kv_dtype)
    table = np.zeros((b, mp), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for i, n in enumerate(lengths):
        if i < 6:
            live = -(-n // ps)
            table[i, :live] = [free.pop() for _ in range(live)]
    q = _randn(rng, (b, hq, d), dev, dt)
    return (q, kc, vc, torch.from_numpy(table).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev)), dict(k_scales=ks,
                                                                         v_scales=vs)


def _quantized_routes(counts, num_splits, dtype) -> bool:
    """The one launch went to the quantized entry of its split kind, on the
    tensor cores for bf16 q (both its counters) and on the CUDA cores for
    float32 q."""
    key = "paged_flash_decode_q" if num_splits == 1 else "paged_flash_decode_split_q"
    want = {key: 1, key + "_tc": 1} if dtype == torch.bfloat16 else {key: 1}
    return {k: n for k, n in counts.items() if n} == want


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("num_splits", [1, 2, 4])
def test_quantized_paged_decode_matches_plain(cuda, kv_dtype, dtype, num_splits):
    """K3q / K4q at the serve shape over the full table, as a fused graph
    runs them: live rows within the bar of q's dtype, the length-0 row
    exactly zero, and the garbage on the null page (NaN codes and scales)
    in no live row. bf16 q runs on the tensor cores, where ten reruns give
    the same bits."""
    dt = DTYPES[dtype]
    args, scales = _serve_decode_inputs(np.random.default_rng(80 + num_splits), cuda, dt,
                                        kv_dtype)
    kernels.reset_launch_counts()
    o = pd.paged_flash_decode(*args, num_splits=num_splits, **scales)
    counts = kernels.launch_counts()
    o_ref = pd.paged_flash_decode_plain(*args, num_splits=num_splits, **scales)
    torch.cuda.synchronize()
    assert _quantized_routes(counts, num_splits, dt)
    live = [0, 2, 3, 4, 5]
    assert torch.isfinite(o[live].float()).all()
    assert _close(o[live], o_ref[live])
    assert float(o[1].float().abs().max()) == 0.0
    if dt == torch.bfloat16:   # bit for bit, the frozen rows' NaNs too
        bits = o.view(torch.int16)
        assert all(torch.equal(pd.paged_flash_decode(*args, num_splits=num_splits, **scales)
                               .view(torch.int16), bits) for _ in range(10))


def _tc_quantized_inputs(rng, dev, hq, hkv, d, ps, kv_dtype, mp):
    """bf16 q over a quantized pool (NaN garbage on the null page) through
    scattered tables padded with the null page: rows of 0, 1, 50, 17 and
    mp * ps tokens (the last stage of the 50- and 17-token rows has fewer
    live pages than a stage holds at ps 8 and 16)."""
    lengths = [0, 1, 50, 17, mp * ps]
    b = len(lengths)
    num_pages = 1 + b * mp
    kc, ks, vc, vs = _quantized(rng, dev, hkv, num_pages, ps, d, kv_dtype)
    table = np.zeros((b, mp), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for i, n in enumerate(lengths):
        live = -(-n // ps)
        table[i, :live] = [free.pop() for _ in range(live)]
    q = _randn(rng, (b, hq, d), dev, torch.bfloat16)
    return (q, kc, vc, torch.from_numpy(table).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev)), dict(k_scales=ks,
                                                                         v_scales=vs)


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("ps", [8, 16, 32, 64])
@pytest.mark.parametrize("num_splits", [1, 4, 7])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (25, 5, 64), (32, 1, 128)],
                         ids=["llama", "hymba", "group32"])
@pytest.mark.parametrize("window,softcap", [(None, None), (75, 30.0)],
                         ids=["full", "window_softcap"])
def test_quantized_paged_decode_tensor_cores_every_page_size(cuda, kv_dtype, ps, num_splits,
                                                             hq, hkv, d, window, softcap):
    """K3q / K4q on the tensor cores at every page size and head width:
    each live row within ROW_TOL of the plain version, the length-0 row
    exactly zero; window 75 starts mid-page on every row longer than it."""
    args, scales = _tc_quantized_inputs(np.random.default_rng(170 + ps), cuda, hq, hkv, d, ps,
                                        kv_dtype, mp=1280 // ps)
    kw = dict(num_splits=num_splits, window=window, softcap=softcap, **scales)
    kernels.reset_launch_counts()
    o = pd.paged_flash_decode(*args, **kw)
    assert _quantized_routes(kernels.launch_counts(), num_splits, torch.bfloat16)
    o_ref = pd.paged_flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    assert _close(o, o_ref)
    assert float(o[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("kv_dtype", CODES)
def test_quantized_tensor_cores_widen_every_code_exactly(cuda, kv_dtype):
    """A row of one token outputs its V row times its page's V scale: with
    scale 1 every code's bf16 widening shows in the output bit for bit.
    Two rows of one token read pages whose first V row holds the codes 0 ..
    127 and 128 .. 255 (e4m3's two NaN codes excepted); K too holds every
    code."""
    from repro_torch.cache import quant

    d, ps = 128, 16
    codes = torch.zeros((1, 3, ps, d), dtype=torch.uint8)
    codes[0, 1:, :2] = torch.arange(256, dtype=torch.uint8).reshape(2, 1, d).expand(2, 2, d)
    if kv_dtype == "fp8":
        codes[(codes & 0x7F) == 0x7F] = 0
    codes = codes.to(cuda).view(quant.storage_dtype(kv_dtype))
    ones = torch.ones((1, 3), device=cuda)
    q = _randn(np.random.default_rng(5), (2, 1, d), cuda, torch.bfloat16)
    table = torch.tensor([[1, 0], [2, 0]], dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    for ns in (1, 2):
        o = pd.paged_flash_decode(q, codes, codes, table, lengths, num_splits=ns,
                                  k_scales=ones, v_scales=ones)
        torch.cuda.synchronize()
        assert torch.equal(o[:, 0].float(), codes[0, 1:, 0].float())


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("window", [None, 40])
def test_quantized_paged_decode_ignores_rows_past_length(cuda, kv_dtype, ps, window):
    """The tensor-core kernel loads whole pages of codes, so it reads the
    rows past each length inside the row's last live page (and loads that
    page again into a last stage's surplus slots): widened as zeros by
    select, codes there that are NaN bits in e4m3 (127 in int8) give the
    bits of zeros there. Ten reruns give the same bits."""
    args, scales = _tc_quantized_inputs(np.random.default_rng(172), cuda, 8, 2, 128, ps,
                                        kv_dtype, mp=1280 // ps)
    q, kc, vc, table, lengths = args
    for ns in (1, 3):
        outs = []
        for byte in (0, 0x7F):
            k, v = kc.clone(), vc.clone()
            for bi, length in enumerate(lengths.tolist()):
                if length % ps:
                    page = int(table[bi, length // ps])
                    for codes in (k, v):
                        codes.view(torch.uint8)[:, page, length % ps:] = byte
            outs.append(pd.paged_flash_decode(q, k, v, table, lengths, window=window,
                                              num_splits=ns, **scales))
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        assert bool(torch.isfinite(outs[1].float()).all())
        assert all(torch.equal(pd.paged_flash_decode(q, k, v, table, lengths, window=window,
                                                     num_splits=ns, **scales), outs[1])
                   for _ in range(10))


def test_quantized_tensor_cores_take_page_sizes_of_8(cuda):
    """bf16 q over a quantized pool of pages of 4 rows raises (the
    tensor-core stages need multiples of 8) and launches nothing; float32 q
    over it, and the CUDA-core walk kept for bf16 q, take it."""
    rng = np.random.default_rng(32)
    args, scales = _serve_decode_inputs(rng, cuda, torch.bfloat16, "int8")
    q, _, _, _, lengths = args
    kc, ks, vc, vs = _quantized(rng, cuda, 8, 1 + 8 * 40, 4, 128, "int8")
    table = torch.arange(1, 1 + 8 * 40, dtype=torch.int32, device=cuda).reshape(8, 40)
    lengths = torch.full_like(lengths, 150)
    kw = dict(k_scales=ks, v_scales=vs)
    kernels.reset_launch_counts()
    for ns in (1, 3):
        with pytest.raises(ValueError, match="multiple of 8"):
            pd.paged_flash_decode(q, kc, vc, table, lengths, num_splits=ns, **kw)
    assert sum(kernels.launch_counts().values()) == 0
    ref = pd.paged_flash_decode_plain(q, kc, vc, table, lengths, **kw)
    assert _close(pd.paged_flash_decode_q_cuda_cores(q, kc, vc, table, lengths, **kw), ref)
    o32 = pd.paged_flash_decode(q.float(), kc, vc, table, lengths, **kw)
    assert _close(o32, pd.paged_flash_decode_plain(q.float(), kc, vc, table, lengths, **kw))
    counts = kernels.launch_counts()
    assert counts["paged_flash_decode_q"] == 2 and counts["paged_flash_decode_q_tc"] == 0


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window,softcap", [(None, None), (50, 30.0)],
                         ids=["full", "window_softcap"])
def test_quantized_paged_prefill_matches_plain(cuda, kv_dtype, dtype, window, softcap):
    """K2q: quantized prefix pages through a table padded with the garbage
    null page, a fresh tail in q's dtype; rows past tail_len exactly zero."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(90)
    q, _, _, table, kt, vt, plen, tlen = _prefill_inputs(rng, cuda, dt, 32, 8)
    kc, ks, vc, vs = _quantized(rng, cuda, 8, 24, 16, 128, kv_dtype)
    table = torch.cat([table, torch.zeros_like(table[:, :3])], dim=1)   # null-page padding
    args = (q, kc, vc, table, kt, vt, plen, tlen)
    kw = dict(window=window, softcap=softcap, k_scales=ks, v_scales=vs)
    kernels.reset_launch_counts()
    o = pp.paged_flash_prefill(*args, **kw)
    assert _prefill_q_routes(kernels.launch_counts(), dt)
    o_ref = pp.paged_flash_prefill_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    assert _close(o, o_ref)
    assert float(o[1, :, 41:].float().abs().max()) == 0.0


def _prefill_q_routes(counts, dtype, launched=1) -> bool:
    """The launches went to K2's quantized entry, on the tensor cores for
    bf16 q (both its counters) and on the CUDA cores for float32 q."""
    want = {"paged_flash_prefill_q": launched}
    if dtype == torch.bfloat16:
        want["paged_flash_prefill_q_tc"] = launched
    return {k: n for k, n in counts.items() if n} == want


def _k2q_inputs(rng, dev, hq, hkv, d, ps, case, kv_dtype):
    """``TC_PREFILL``'s shapes over a quantized pool whose null page (0)
    holds NaN scales and e4m3 NaN codes, through scattered tables padded
    with 3 null pages."""
    q, _, _, table, kt, vt, plen, tlen = _tc_prefill_inputs(rng, dev, hq, hkv, d, ps, case)
    kc, ks, vc, vs = _quantized(rng, dev, hkv, 1 + table.numel(), ps, d, kv_dtype)
    table = torch.cat([table, torch.zeros((table.shape[0], 3), dtype=table.dtype, device=dev)],
                      dim=1)
    return (q, kc, vc, table, kt, vt, plen, tlen), dict(k_scales=ks, v_scales=vs)


def _dequantized_bf16(codes, scales):
    from repro_torch.cache import quant

    return quant.dequantize_pages(codes, scales).to(torch.bfloat16)


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("case", sorted(TC_PREFILL))
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (25, 5, 64)], ids=["llama", "hymba"])
@pytest.mark.parametrize("window,softcap", [(None, None), (75, 30.0)],
                         ids=["full", "window_softcap"])
def test_quantized_paged_prefill_tensor_cores_equal_k2_on_dequantized_pools(
        cuda, kv_dtype, ps, case, hq, hkv, d, window, softcap):
    """K2q for bf16 q is bit for bit K2 (``paged_prefill_tc``) over bf16
    pools of the dequantized values: its converters store
    ``dequantize_pages(codes, scales).to(bfloat16)`` where K2's TMA would,
    zeros past the live prefix (which K2 masks), and the consumers are K2's.
    It holds ROW_TOL against the plain version; rows past tail_len are
    exact zeros."""
    args, scales = _k2q_inputs(np.random.default_rng(190 + ps), cuda, hq, hkv, d, ps, case,
                               kv_dtype)
    q, kc, vc, table, kt, vt, plen, tlen = args
    kw = dict(window=window, softcap=softcap)
    kernels.reset_launch_counts()
    o = pp.paged_flash_prefill(*args, **kw, **scales)
    assert _prefill_q_routes(kernels.launch_counts(), torch.bfloat16)
    o_bf = pp.paged_flash_prefill(q, _dequantized_bf16(kc, scales["k_scales"]),
                                  _dequantized_bf16(vc, scales["v_scales"]), table, kt, vt,
                                  plen, tlen, **kw)
    o_ref = pp.paged_flash_prefill_plain(*args, **kw, **scales)
    torch.cuda.synchronize()
    assert torch.equal(o, o_bf)
    assert _row_err(o, o_ref) < ROW_TOL
    for bi, t in enumerate(tlen.tolist()):
        assert float(o[bi, :, t:].float().abs().sum()) == 0.0


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("window", [None, 40])
def test_quantized_paged_prefill_tensor_cores_ignore_codes_past_prefix(cuda, kv_dtype, ps,
                                                                      window):
    """K2q loads whole pages of codes, so it reads the positions past
    prefix_len inside the last live page (and that page again into a last
    stage's surplus slots): written as 0 by select, codes 0x7F there (NaN
    bits in e4m3, 127 in int8) give the bits of codes 0. 100 reruns give
    the same bits."""
    args, scales = _k2q_inputs(np.random.default_rng(193), cuda, 32, 8, 128, ps,
                               "two_row_tiles", kv_dtype)
    q, kc, vc, table, kt, vt, plen, tlen = args
    outs = []
    for byte in (0, 0x7F):
        k, v = kc.clone(), vc.clone()
        for bi, n in enumerate(plen.tolist()):
            if n % ps:
                page = int(table[bi, n // ps])
                for codes in (k, v):
                    codes.view(torch.uint8)[:, page, n % ps:] = byte
        outs.append(pp.paged_flash_prefill(q, k, v, table, kt, vt, plen, tlen, window=window,
                                           **scales))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert bool(torch.isfinite(outs[1].float()).all())
    assert all(torch.equal(pp.paged_flash_prefill(q, k, v, table, kt, vt, plen, tlen,
                                                  window=window, **scales), outs[1])
               for _ in range(100))


def test_quantized_paged_prefill_tensor_cores_take_page_sizes_of_8(cuda):
    """bf16 q over a quantized pool of pages of 12 rows raises (the
    tensor-core stages need a multiple of 8 that divides 128) and launches
    nothing; float32 q over it, and the CUDA-core walk kept for bf16 q, take
    it, within their bars."""
    rng = np.random.default_rng(94)
    args, scales = _k2q_inputs(rng, cuda, 8, 2, 64, 12, "ragged", "int8")
    args32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="page_size"):
        pp.paged_flash_prefill(*args, **scales)
    assert sum(kernels.launch_counts().values()) == 0
    ref = pp.paged_flash_prefill_plain(*args, **scales)
    assert _close(pp.paged_flash_prefill_q_cuda_cores(*args, **scales), ref)
    o32 = pp.paged_flash_prefill(*args32, **scales)
    assert _close(o32, pp.paged_flash_prefill_plain(*args32, **scales))
    assert _prefill_q_routes(kernels.launch_counts(), torch.float32, launched=2)


def test_closed_graph_engines_hold_no_device_memory(cuda):
    """Engines that capture decode graphs all capture on one stream per
    card, so closing them returns what they took. One engine is built,
    stepped and closed first, so the default and capture streams' cuBLAS
    workspaces exist before the start is read, whatever ran before; then
    more than the stream pool's 32 of them, each built, stepped and
    closed, leave memory_allocated() within one cuBLAS workspace (32 MiB)
    of that start."""
    import gc

    cfg = _graph_cfg()
    params = transformer.init_model(cfg, seed=0, device=cuda)

    def build_step_close(seed):
        eng = LLMEngine(cfg, params, steps_per_sync=2, device=cuda, **_GRAPH_KW["paged"])
        eng.generate(_graph_requests(cfg, seed=seed, max_tokens=3)[:1])
        assert eng.backend.stats["decode_traces"] >= 1
        eng.close()

    build_step_close(59)
    gc.collect()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    for i in range(34):
        build_step_close(60 + i)
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - start <= 32 << 20


# -- telemetry and the load harness on the card ----------------------------------


@pytest.mark.parametrize("steps", [1, 8])
def test_paged_engine_telemetry_keeps_greedy_ids(cuda, steps):
    """A paged bf16 graph engine with telemetry on gives the ids of the same
    engine with telemetry off; its spans, lifecycle events and drift cells
    are recorded, outside the graphs (a replay adds its capture's launches,
    nothing else)."""
    from repro_torch.obs import Telemetry

    cfg = _graph_cfg()
    params = transformer.init_model(cfg, seed=0, device=cuda)
    ids, tels = {}, {}
    for name, tel in (("off", None), ("on", Telemetry.create())):
        eng = LLMEngine(cfg, params, steps_per_sync=steps, device=cuda, telemetry=tel,
                        **_GRAPH_KW["paged"])
        out = eng.generate(_graph_requests(cfg))
        ids[name] = {o.uid: [int(t) for t in o.tokens] for o in out}
        tels[name] = tel
        eng.close()
    assert ids["on"] == ids["off"]
    tel = tels["on"]
    snap = tel.metrics.snapshot()
    assert snap["serving_tokens_total"]["value"] == sum(len(t) for t in ids["on"].values())
    assert {"step", "schedule", "flush", "decode"} <= {s.name for s in tel.tracer.spans}
    for uid in ids["on"]:
        names = [e for e, _, _ in tel.tracer.request_lifecycle(uid)]
        assert names[0] == "arrival" and names[-1] == "finish" and "first_token" in names
    assert tel.drift.num_samples > 0


def test_loadgen_run_one_on_the_card(cuda, tmp_path):
    """``loadgen.run_one`` on llama3-8b SMOKE (widened to head_dim 64 in
    bf16: the kernels take 64 and 128), paged, on the card: the harness's
    smoke check passes and no graph is captured after warm-up."""
    import argparse

    from repro_torch.launch import loadgen

    args = argparse.Namespace(
        arch="llama3-8b", smoke=True, requests=8, rate=100.0, max_batch=4, cache_len=128,
        num_pages=96, page_size=16, shared_prefix=16, shared_fraction=0.5, temperature=0.0,
        seed=0, out_dir=str(tmp_path), device="cuda", steps_per_sync=1)
    payload = loadgen.run_one(args, "paged", cfg=_graph_cfg())
    loadgen._smoke_check(payload)
    assert payload["decode_retraces_after_warmup"] == 0
    assert payload["device"].startswith("cuda")


# -- head_dim 256 (the gemma family): K1, K2, K3/K4, K7/K8 in bf16 ------------

# (Hq, Hkv): gemma2-2b's groups of 2, gemma3-1b's group of 4 over one kv head.
GEMMA_HEADS = [(8, 4), (4, 1)]
GEMMA_IDS = ["gemma2", "gemma3"]
# Softcap 50 everywhere (gemma2's), with gemma2's local window 4096 and
# gemma3's 512 beside the global layers' none.
GEMMA_WINDOWS = [None, 512, 4096]


@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS, ids=GEMMA_IDS)
@pytest.mark.parametrize("window", GEMMA_WINDOWS)
def test_d256_flash_fwd_matches_plain(cuda, mapping, hq, hkv, window):
    """K1 at head_dim 256 walks 64-key tiles: B 2 of 700 queries, and one
    row of 4200 where window 4096 bites, under each launch; on the tensor
    cores (its own count moves), per row within 2^-6, lse within 1e-5."""
    rng = np.random.default_rng(80)
    for b, s in ((2, 700), (1, 4200)):
        q = _randn(rng, (b, hq, s, 256), cuda, torch.bfloat16)
        k, v = (_randn(rng, (b, hkv, s, 256), cuda, torch.bfloat16) for _ in range(2))
        kw = dict(causal=True, window=window, softcap=50.0)
        kernels.reset_launch_counts()
        o, lse = fa.flash_attention_fwd(q, k, v, mapping=MAPPINGS[mapping], **kw)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["flash_attention_fwd_tc"] == 1
        assert _row_err(o, o_ref) < ROW_TOL and _err(lse, lse_ref) < LSE_TOL


@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS, ids=GEMMA_IDS)
@pytest.mark.parametrize("window", [None, 90])
def test_d256_flash_fwd_per_row_offsets_match_plain(cuda, hq, hkv, window):
    """K1 at head_dim 256 with per-row query offsets and kv_len (three rows
    of 150 queries at 0, 37 and 300 over 500 keys), softcap 50; offset 0
    as arrays gives the null pointers' bits."""
    rng = np.random.default_rng(81)
    q = _randn(rng, (3, hq, 150, 256), cuda, torch.bfloat16)
    k, v = (_randn(rng, (3, hkv, 500, 256), cuda, torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, window=window, softcap=50.0,
              q_offset=torch.tensor([0, 37, 300], dtype=torch.int32, device=cuda),
              kv_len=torch.tensor([150, 182, 450], dtype=torch.int32, device=cuda))
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
    zero = fa.flash_attention_fwd(q, k, v, causal=True, window=window, softcap=50.0,
                                  q_offset=torch.zeros((3,), device=cuda),
                                  kv_len=torch.full((3,), 500, device=cuda))
    null = fa.flash_attention_fwd(q, k, v, causal=True, window=window, softcap=50.0)
    torch.cuda.synchronize()
    assert _row_err(o, o_ref) < ROW_TOL and _err(lse, lse_ref) < LSE_TOL
    assert all(torch.equal(a, b) for a, b in zip(zero, null))


@pytest.mark.parametrize("ps", [8, 16, 32, 64])
@pytest.mark.parametrize("case", sorted(TC_PREFILL))
@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS, ids=GEMMA_IDS)
@pytest.mark.parametrize("window", [None, 75])
def test_d256_paged_prefill_matches_plain(cuda, ps, case, hq, hkv, window):
    """K2 at head_dim 256: a 64-key stage holds 64 / ps pages."""
    args = _tc_prefill_inputs(np.random.default_rng(82 + ps), cuda, hq, hkv, 256, ps, case)
    kw = dict(window=window, softcap=50.0)
    kernels.reset_launch_counts()
    o = pp.paged_flash_prefill(*args, **kw)
    counts = kernels.launch_counts()
    assert counts["paged_flash_prefill"] == counts["paged_flash_prefill_tc"] == 1
    o_ref = pp.paged_flash_prefill_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _row_err(o, o_ref) < ROW_TOL
    tlen = args[-1].tolist()
    assert all(float(o[bi, :, n:].float().abs().sum()) == 0.0 for bi, n in enumerate(tlen))


@pytest.mark.parametrize("ps", [8, 16, 32, 64])
@pytest.mark.parametrize("num_splits", [1, 3, 8])
@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS, ids=GEMMA_IDS)
@pytest.mark.parametrize("window", [None, 75])
def test_d256_paged_decode_matches_plain(cuda, ps, num_splits, hq, hkv, window):
    """K3 / K4 at head_dim 256 (the four warps share each 64-row tile by
    64-column chunks of D): rows of 0, 1, 50, 17 and 1280 tokens, then three rows frozen
    on the null page at the full table width (table all 0, lengths 0 and
    1), as a graph runs a free row; the null page holds random rows."""
    rng = np.random.default_rng(84 + ps)
    q, kp, vp, table, lengths = _decode_inputs(rng, cuda, torch.bfloat16, hq, hkv, d=256,
                                               ps=ps, mp=1280 // ps)
    q = torch.cat([q, _randn(rng, (3, hq, 256), cuda, torch.bfloat16)])
    table = torch.cat([table, torch.zeros((3, table.shape[1]), dtype=torch.int32,
                                          device=cuda)])
    lengths = torch.cat([lengths, torch.tensor([0, 1, 0], dtype=torch.int32, device=cuda)])
    kw = dict(num_splits=num_splits, window=window, softcap=50.0)
    kernels.reset_launch_counts()
    o = pd.paged_flash_decode(q, kp, vp, table, lengths, **kw)
    assert _paged_routes(kernels.launch_counts(), torch.bfloat16)
    o_ref = pd.paged_flash_decode_plain(q, kp, vp, table, lengths, **kw)
    torch.cuda.synchronize()
    assert _row_err(o, o_ref) < ROW_TOL
    assert float(o[[0, 5, 7]].float().abs().max()) == 0.0


@pytest.mark.parametrize("num_splits", [1, 3, 8])
@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS, ids=GEMMA_IDS)
@pytest.mark.parametrize("smax,window", [(1024, None), (1024, 512), (4352, 4096)])
def test_d256_dense_decode_matches_plain(cuda, num_splits, hq, hkv, smax, window):
    """K7 / K8 at head_dim 256, softcap 50, on the tensor cores."""
    rng = np.random.default_rng(86)
    q, kc, vc, lengths = _dense_inputs(rng, cuda, torch.bfloat16, hq, hkv, 256, smax)
    kw = dict(window=window, softcap=50.0, num_splits=num_splits)
    kernels.reset_launch_counts()
    o = dd.flash_decode(q, kc, vc, lengths, **kw)
    assert _dense_routes(kernels.launch_counts(), torch.bfloat16)
    ref = dd.flash_decode_plain(q, kc, vc, lengths, **kw)
    torch.cuda.synchronize()
    assert _row_err(o, ref) < ROW_TOL
    assert float(o[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("num_splits", [1, 3])
def test_d256_decode_group_32_matches_plain(cuda, layout, num_splits):
    """K3 / K4 and K7 / K8 at head_dim 256 with a group of 32 (two m16
    tiles, which take the partial-S exchange in turn), window 75, softcap
    50: paged rows of 0, 1, 50, 17 and 1280 tokens, dense rows of 0, 1,
    37, 643, 1275 and 1280."""
    rng = np.random.default_rng(87)
    kw = dict(num_splits=num_splits, window=75, softcap=50.0)
    kernels.reset_launch_counts()
    if layout == "paged":
        args = _decode_inputs(rng, cuda, torch.bfloat16, 32, 1, d=256, ps=16, mp=80)
        o = pd.paged_flash_decode(*args, **kw)
        assert _paged_routes(kernels.launch_counts(), torch.bfloat16)
        ref = pd.paged_flash_decode_plain(*args, **kw)
    else:
        args = _dense_inputs(rng, cuda, torch.bfloat16, 32, 1, 256, 1280)
        o = dd.flash_decode(*args, **kw)
        assert _dense_routes(kernels.launch_counts(), torch.bfloat16)
        ref = dd.flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _row_err(o, ref) < ROW_TOL


# -- head_dim 256 over int8 and fp8 pools: K2q, K3q / K4q in bf16 --------------

#: Windows of the quantized head_dim 256 cases: none, 100 (starts mid-page)
#: and gemma2's 4096, which bites on the rows of 4352 positions.
D256_Q_WINDOWS = [None, 100, 4096]


def _d256_quantized_decode_inputs(rng, dev, hq, hkv, ps, kv_dtype):
    """bf16 q over a quantized pool at head_dim 256 (NaN codes and scales
    on the null page): rows of 0, 1, 50, 17 and 4352 tokens over scattered
    tables padded with the null page, then three rows frozen on the null
    page (table all 0, lengths 0, 1 and 0), as a graph runs a free row."""
    args, scales = _tc_quantized_inputs(rng, dev, hq, hkv, 256, ps, kv_dtype, mp=4352 // ps)
    q, kc, vc, table, lengths = args
    q = torch.cat([q, _randn(rng, (3, hq, 256), dev, torch.bfloat16)])
    table = torch.cat([table, torch.zeros((3, table.shape[1]), dtype=torch.int32, device=dev)])
    lengths = torch.cat([lengths, torch.tensor([0, 1, 0], dtype=torch.int32, device=dev)])
    return (q, kc, vc, table, lengths), scales


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("num_splits", [1, 4])
@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS + [(32, 1)], ids=GEMMA_IDS + ["group32"])
@pytest.mark.parametrize("window", D256_Q_WINDOWS)
def test_d256_quantized_paged_decode_matches_plain(cuda, kv_dtype, ps, num_splits, hq, hkv,
                                                    window):
    """K3q / K4q at head_dim 256 (a widening warpgroup turns each code
    stage into a bf16 stage, which the four consumer warps read as over a
    bf16 pool): softcap 50, live rows within ROW_TOL of the plain version
    and finite, the length-0 and frozen length-0 rows exactly zero, every
    launch on the tensor cores, ten reruns bitwise equal (the frozen rows'
    bits too)."""
    args, scales = _d256_quantized_decode_inputs(np.random.default_rng(200 + ps), cuda, hq,
                                                 hkv, ps, kv_dtype)
    kw = dict(num_splits=num_splits, window=window, softcap=50.0, **scales)
    kernels.reset_launch_counts()
    o = pd.paged_flash_decode(*args, **kw)
    assert _quantized_routes(kernels.launch_counts(), num_splits, torch.bfloat16)
    o_ref = pd.paged_flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    live = [0, 1, 2, 3, 4]   # row 6 reads the null page's NaNs, as the plain version does
    assert torch.isfinite(o[live].float()).all()
    assert _row_err(o[live], o_ref[live]) < ROW_TOL
    assert float(o[[0, 5, 7]].float().abs().max()) == 0.0
    bits = o.view(torch.int16)
    assert all(torch.equal(pd.paged_flash_decode(*args, **kw).view(torch.int16), bits)
               for _ in range(10))


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("num_splits", [1, 3])
def test_d256_quantized_paged_decode_ignores_rows_past_length(cuda, kv_dtype, num_splits):
    """At head_dim 256 too, codes that are NaN bits in e4m3 (127 in int8)
    in the rows past each length inside its last live page give the bits
    of zeros there."""
    args, scales = _tc_quantized_inputs(np.random.default_rng(205), cuda, 8, 4, 256, 16,
                                        kv_dtype, mp=80)
    q, kc, vc, table, lengths = args
    outs = []
    for byte in (0, 0x7F):
        k, v = kc.clone(), vc.clone()
        for bi, length in enumerate(lengths.tolist()):
            if length % 16:
                page = int(table[bi, length // 16])
                for codes in (k, v):
                    codes.view(torch.uint8)[:, page, length % 16:] = byte
        outs.append(pd.paged_flash_decode(q, k, v, table, lengths, num_splits=num_splits,
                                          softcap=50.0, **scales))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert bool(torch.isfinite(outs[1].float()).all())


#: Row lengths of the head_dim 256 ring test: one-pass walks of exactly 1,
#: 2, 3 and 5 tiles of 64 keys (the 100-token row's second stage half
#: surplus slots), a row of 1 and a row of 0, on a 320-token table.
D256_WALK_LENGTHS = [64, 100, 192, 320, 1, 0]


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("num_splits", [1, 2, 8])
@pytest.mark.parametrize("hq,hkv", [(8, 4), (32, 1)], ids=["gemma2", "group32"])
def test_d256_quantized_paged_decode_rings_wrap(cuda, kv_dtype, ps, num_splits, hq, hkv):
    """K3q / K4q at head_dim 256 over their three rings (three code
    stages, two bf16 K stages, one bf16 V stage): one-pass walks of exactly
    1, 2, 3 and 5 tiles, so that each ring wraps at its own depth; at 2 and
    8 splits more splits than the short rows have pages, so that blocks
    with no tile run beside live ones; three rows frozen on the null page
    at the full table width (NaN codes and scales there), as the fused
    decode's graph runs them; two m16 tiles (group 32) at pages of 8, 32
    boxes a code stage. Live rows within ROW_TOL of the plain version and
    finite, length-0 rows exactly zero, every launch on the tensor cores,
    ten reruns bitwise equal."""
    rng = np.random.default_rng(220 + ps + num_splits)
    lengths = D256_WALK_LENGTHS
    mp = 320 // ps
    b = len(lengths)
    kc, ks, vc, vs = _quantized(rng, cuda, hkv, 1 + b * mp, ps, 256, kv_dtype)
    table = np.zeros((b + 3, mp), np.int32)
    free = list(rng.permutation(np.arange(1, 1 + b * mp)))
    for i, n in enumerate(lengths):
        table[i, :-(-n // ps)] = [free.pop() for _ in range(-(-n // ps))]
    q = _randn(rng, (b + 3, hq, 256), cuda, torch.bfloat16)
    args = (q, kc, vc, torch.from_numpy(table).to(cuda),
            torch.tensor(lengths + [0, 1, 0], dtype=torch.int32, device=cuda))
    kw = dict(num_splits=num_splits, softcap=50.0, k_scales=ks, v_scales=vs)
    kernels.reset_launch_counts()
    o = pd.paged_flash_decode(*args, **kw)
    assert _quantized_routes(kernels.launch_counts(), num_splits, torch.bfloat16)
    o_ref = pd.paged_flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    live = [0, 1, 2, 3, 4]   # row 7 reads the null page's NaNs, as the plain version does
    assert torch.isfinite(o[live].float()).all()
    assert _row_err(o[live], o_ref[live]) < ROW_TOL
    assert float(o[[5, 6, 8]].float().abs().max()) == 0.0
    bits = o.view(torch.int16)
    assert all(torch.equal(pd.paged_flash_decode(*args, **kw).view(torch.int16), bits)
               for _ in range(10))


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("ps", [8, 16, 32, 64])
@pytest.mark.parametrize("case", sorted(TC_PREFILL))
@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS, ids=GEMMA_IDS)
@pytest.mark.parametrize("window", [None, 100])
def test_d256_quantized_paged_prefill_equals_k2_on_dequantized_pools(cuda, kv_dtype, ps, case,
                                                                     hq, hkv, window):
    """K2q at head_dim 256 (64-key stages; a code ring, a bf16 K ring and
    a bf16 V ring; two 128-byte code boxes a page, 64 / ps pages a stage)
    is bit for bit K2 over bf16 pools of the dequantized values, softcap
    50, within ROW_TOL of the plain version, rows past tail_len exact
    zeros, ten reruns bitwise equal; the null page holds NaN scales and
    codes."""
    args, scales = _k2q_inputs(np.random.default_rng(210 + ps), cuda, hq, hkv, 256, ps, case,
                               kv_dtype)
    q, kc, vc, table, kt, vt, plen, tlen = args
    kw = dict(window=window, softcap=50.0)
    kernels.reset_launch_counts()
    o = pp.paged_flash_prefill(*args, **kw, **scales)
    assert _prefill_q_routes(kernels.launch_counts(), torch.bfloat16)
    o_bf = pp.paged_flash_prefill(q, _dequantized_bf16(kc, scales["k_scales"]),
                                  _dequantized_bf16(vc, scales["v_scales"]), table, kt, vt,
                                  plen, tlen, **kw)
    o_ref = pp.paged_flash_prefill_plain(*args, **kw, **scales)
    torch.cuda.synchronize()
    assert torch.equal(o, o_bf)
    assert _row_err(o, o_ref) < ROW_TOL
    for bi, t in enumerate(tlen.tolist()):
        assert float(o[bi, :, t:].float().abs().sum()) == 0.0
    assert all(torch.equal(pp.paged_flash_prefill(*args, **kw, **scales), o) for _ in range(10))


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS, ids=GEMMA_IDS)
@pytest.mark.parametrize("window", D256_Q_WINDOWS)
def test_d256_quantized_paged_prefill_long_prefix(cuda, kv_dtype, hq, hkv, window):
    """K2q at head_dim 256 over a prefix of 4300 positions (a ragged last
    page of 16) and a tail of 130, the second row live to 77: window 4096
    bites, and the walk starts at the page of each row tile's first
    visible position. Bit for bit K2 over the dequantized pools, within
    ROW_TOL of the plain version."""
    rng = np.random.default_rng(215)
    b, ps, st, plen = 2, 16, 130, 4300
    mp = -(-plen // ps)
    kc, ks, vc, vs = _quantized(rng, cuda, hkv, 1 + b * mp, ps, 256, kv_dtype)
    table = torch.from_numpy(rng.permutation(np.arange(1, 1 + b * mp)).reshape(b, mp)
                             .astype(np.int32)).to(cuda)
    q = _randn(rng, (b, hq, st, 256), cuda, torch.bfloat16)
    kt, vt = (_randn(rng, (b, hkv, st, 256), cuda, torch.bfloat16) for _ in range(2))
    plens = torch.full((b,), plen, dtype=torch.int32, device=cuda)
    tl = torch.tensor([st, 77], dtype=torch.int32, device=cuda)
    args = (q, kc, vc, table, kt, vt, plens, tl)
    kw = dict(window=window, softcap=50.0, k_scales=ks, v_scales=vs)
    o = pp.paged_flash_prefill(*args, **kw)
    o_bf = pp.paged_flash_prefill(q, _dequantized_bf16(kc, ks), _dequantized_bf16(vc, vs),
                                  table, kt, vt, plens, tl, window=window, softcap=50.0)
    o_ref = pp.paged_flash_prefill_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o_bf)
    assert _row_err(o, o_ref) < ROW_TOL
    assert float(o[1, :, 77:].float().abs().sum()) == 0.0
    assert all(torch.equal(pp.paged_flash_prefill(*args, **kw), o) for _ in range(10))


@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("prefix_tiles", [1, 2, 3, 5])
@pytest.mark.parametrize("tail_tiles", [1, 2, 3])
def test_d256_quantized_paged_prefill_rings_wrap(cuda, kv_dtype, prefix_tiles, tail_tiles):
    """K2q at head_dim 256 over prefix walks of exactly 1, 2, 3 and 5
    64-key tiles (row 0 a whole number of tiles, row 1 the last tile 27
    rows live), then tails of 1, 2 and 3 tiles (row 1 live to 37 fewer):
    each ring (code, bf16 K, bf16 V) wraps at its own depth and the
    prefix-to-tail handover lands on every phase. gemma2-2b's heads,
    softcap 50, pages of 16. Bit for bit K2 over the dequantized pools,
    within ROW_TOL of the plain version, rows past tail_len exact zeros,
    ten reruns bitwise equal."""
    rng = np.random.default_rng(230 + 10 * prefix_tiles + tail_tiles)
    b, hq, hkv, ps = 2, 8, 4, 16
    st = 64 * tail_tiles
    plen = [64 * prefix_tiles, 64 * prefix_tiles - 37]
    tlens = [st, st - 37]
    mp = -(-max(plen) // ps)
    kc, ks, vc, vs = _quantized(rng, cuda, hkv, 1 + b * mp, ps, 256, kv_dtype)
    table = torch.from_numpy(rng.permutation(np.arange(1, 1 + b * mp)).reshape(b, mp)
                             .astype(np.int32)).to(cuda)
    q = _randn(rng, (b, hq, st, 256), cuda, torch.bfloat16)
    kt, vt = (_randn(rng, (b, hkv, st, 256), cuda, torch.bfloat16) for _ in range(2))
    as_int = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda)
    args = (q, kc, vc, table, kt, vt, as_int(plen), as_int(tlens))
    kw = dict(softcap=50.0, k_scales=ks, v_scales=vs)
    kernels.reset_launch_counts()
    o = pp.paged_flash_prefill(*args, **kw)
    assert _prefill_q_routes(kernels.launch_counts(), torch.bfloat16)
    o_bf = pp.paged_flash_prefill(q, _dequantized_bf16(kc, ks), _dequantized_bf16(vc, vs),
                                  table, kt, vt, as_int(plen), as_int(tlens), softcap=50.0)
    o_ref = pp.paged_flash_prefill_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o_bf)
    assert _row_err(o, o_ref) < ROW_TOL
    assert float(o[1, :, st - 37:].float().abs().sum()) == 0.0
    assert all(torch.equal(pp.paged_flash_prefill(*args, **kw), o) for _ in range(10))


@pytest.mark.parametrize("kv_dtype", CODES)
def test_d256_quantized_paged_prefill_reruns_with_a_frozen_row(cuda, kv_dtype):
    """K2q at head_dim 256 at chip_smoke.py's kernel shape (prefix 1000,
    tail 256, the second row live to 219; gemma2-2b's heads, window 4096,
    softcap 50) beside a third row whose whole table is the null page (NaN
    scales, e4m3 NaN codes), as a row frozen there reads it: 100 reruns,
    the L2 flushed before every third, bitwise equal to the first, the
    frozen row's NaNs included; the live rows bit for bit K2 over the
    dequantized pools and within ROW_TOL of the plain version."""
    rng = np.random.default_rng(240)
    b, hq, hkv, ps, st, plen = 3, 8, 4, 16, 256, 1000
    mp = -(-plen // ps)
    kc, ks, vc, vs = _quantized(rng, cuda, hkv, 1 + 2 * mp, ps, 256, kv_dtype)
    table = np.zeros((b, mp), np.int32)
    table[:2] = rng.permutation(np.arange(1, 1 + 2 * mp)).reshape(2, mp)
    table = torch.from_numpy(table).to(cuda)
    q = _randn(rng, (b, hq, st, 256), cuda, torch.bfloat16)
    kt, vt = (_randn(rng, (b, hkv, st, 256), cuda, torch.bfloat16) for _ in range(2))
    as_int = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda)
    args = (q, kc, vc, table, kt, vt, as_int([plen] * b), as_int([st, 219, st]))
    kw = dict(window=4096, softcap=50.0, k_scales=ks, v_scales=vs)
    o = pp.paged_flash_prefill(*args, **kw)
    o_bf = pp.paged_flash_prefill(q, _dequantized_bf16(kc, ks), _dequantized_bf16(vc, vs),
                                  *args[3:], window=4096, softcap=50.0)
    o_ref = pp.paged_flash_prefill_plain(*args, **kw)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    bits = o.view(torch.int16)
    differ = 0
    for i in range(100):
        if i % 3 == 0:
            flush.zero_()
        differ += not torch.equal(pp.paged_flash_prefill(*args, **kw).view(torch.int16), bits)
    torch.cuda.synchronize()
    assert differ == 0
    assert torch.equal(o[:2], o_bf[:2])
    assert _row_err(o[:2], o_ref[:2]) < ROW_TOL
    assert float(o[1, :, 219:].float().abs().sum()) == 0.0


def test_d256_quantized_refuses_pages_of_128(cuda):
    """A quantized pool of 128-row pages at head_dim 256 is refused for
    bf16 q (K2q's and K3q's 64-key stages) and launches nothing."""
    rng = np.random.default_rng(217)
    args, scales = _k2q_inputs(rng, cuda, 8, 4, 256, 128, "ragged", "int8")
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="divides 64"):
        pp.paged_flash_prefill(*args, **scales)
    dargs, dscales = _tc_quantized_inputs(rng, cuda, 8, 4, 256, 128, "fp8", mp=3)
    for ns in (1, 2):
        with pytest.raises(ValueError, match="divide 64"):
            pd.paged_flash_decode(*dargs, num_splits=ns, **dscales)
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts().values()) == 0


def test_d256_refuses_what_no_kernel_takes(cuda):
    """At head_dim 256 the float32 kernels (K1, K2, K3/K4, K5/K6, K7/K8),
    float32 q over a quantized pool (K2q, K3q/K4q on the CUDA cores) and a
    bf16 page of 128 rows (K2's 64-key stage) each raise ValueError on the
    card and launch nothing."""
    from repro_torch.cache import quant

    rng = np.random.default_rng(88)
    kernels.reset_launch_counts()
    x32 = _randn(rng, (1, 4, 130, 256), cuda)
    with pytest.raises(ValueError, match="head_dim 256"):
        fa.flash_attention_fwd(x32, x32, x32)
    with pytest.raises(ValueError, match="head_dim 256"):
        fb.flash_attention_bwd(x32, x32, x32, x32, torch.zeros((1, 4, 130), device=cuda), x32)
    q, kp, vp, table, kt, vt, plen, tlen = _prefill_inputs(rng, cuda, torch.float32, 8, 4,
                                                           d=256)
    with pytest.raises(ValueError, match="head_dim 256"):
        pp.paged_flash_prefill(q, kp, vp, table, kt, vt, plen, tlen)
    (kc, ks), (vc, vs) = (quant.quantize_pages(p, "int8") for p in (kp, vp))
    with pytest.raises(ValueError, match="head_dim 256"):
        pp.paged_flash_prefill(q, kc, vc, table, kt, vt, plen, tlen, k_scales=ks, v_scales=vs)
    big = _tc_prefill_inputs(rng, cuda, 8, 4, 256, 128, "ragged")
    with pytest.raises(ValueError, match="divides 64"):
        pp.paged_flash_prefill(*big)
    dq, dkp, dvp, dtable, dlen = _decode_inputs(rng, cuda, torch.float32, 8, 4, d=256)
    (dkc, dks), (dvc, dvs) = (quant.quantize_pages(p, "fp8") for p in (dkp, dvp))
    for ns in (1, 3):
        with pytest.raises(ValueError, match="head_dim 256"):
            pd.paged_flash_decode(dq, dkp, dvp, dtable, dlen, num_splits=ns)
        with pytest.raises(ValueError, match="head_dim 256"):
            pd.paged_flash_decode(dq, dkc, dvc, dtable, dlen, num_splits=ns, k_scales=dks,
                                  v_scales=dvs)
    sq, skc, svc, slen = _dense_inputs(rng, cuda, torch.float32, 8, 4, 256, 512)
    for ns in (1, 3):
        with pytest.raises(ValueError, match="head_dim 256"):
            dd.flash_decode(sq, skc, svc, slen, num_splits=ns)
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts().values()) == 0


# -- head_dim 256: K5 / K6 in bf16 and gemma training ---------------------------

#: (B, Sq, Skv, kw) of the head_dim 256 backward cases: a ragged causal S
#: (700 = 10 x 64 + 60), window 100, window 4096 over 4200 positions (the
#: window bites), and non-causal keys masked past kv_len; softcap 50 on all
#: but the last.
D256_BWD = {
    "causal_ragged": (2, 700, 700, dict(causal=True, softcap=50.0)),
    "window100": (2, 700, 700, dict(causal=True, window=100, softcap=50.0)),
    "window4096_s4200": (1, 4200, 4200, dict(causal=True, window=4096, softcap=50.0)),
    "noncausal_kvlen": (2, 130, 170, dict(causal=False, kv_len=150)),
}


def _d256_bwd_case(rng, dev, hq, hkv, b, sq, skv, **kw):
    q = _randn(rng, (b, hq, sq, 256), dev, torch.bfloat16)
    k, v = (_randn(rng, (b, hkv, skv, 256), dev, torch.bfloat16) for _ in range(2))
    do = _randn(rng, (b, hq, sq, 256), dev, torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("case", sorted(D256_BWD))
@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS, ids=GEMMA_IDS)
def test_d256_flash_bwd_matches_plain(cuda, case, hq, hkv):
    """K5 / K6 at head_dim 256 on the tensor cores (both warpgroups of a
    block on 64 shared rows), at gemma2-2b's and gemma3-1b's groups: each
    gradient per (b, head) slice within 2^-6 of the plain backward, one
    launch each, both on the tensor cores."""
    b, sq, skv, kw = D256_BWD[case]
    args = _d256_bwd_case(np.random.default_rng(90), cuda, hq, hkv, b, sq, skv, **kw)
    kernels.reset_launch_counts()
    got = fb.flash_attention_bwd(*args, **kw)
    counts = kernels.launch_counts()
    want = fb.flash_attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _bwd_routes(counts, torch.bfloat16), counts
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert _slice_err(g, w) <= ROW_TOL, name
    if kw.get("kv_len") is not None:   # keys past kv_len get no gradient
        assert float(got[1][:, :, 150:].abs().max()) == float(got[2][:, :, 150:].abs().max()) == 0


@pytest.mark.parametrize("hq,hkv", GEMMA_HEADS, ids=GEMMA_IDS)
def test_d256_flash_bwd_fully_masked_rows(cuda, hq, hkv):
    """kv_len 0 masks every row (lse -1e30): at head_dim 256 every gradient
    is exactly 0, no NaN."""
    kw = dict(causal=False, kv_len=0, softcap=50.0)
    q, k, v, o, lse, do = _d256_bwd_case(np.random.default_rng(91), cuda, hq, hkv, 2, 130,
                                         130, **kw)
    kernels.reset_launch_counts()
    dq, dk, dv = fb.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert _bwd_routes(kernels.launch_counts(), torch.bfloat16)
    assert float(dq.abs().max()) == float(dk.abs().max()) == float(dv.abs().max()) == 0.0


def test_d256_flash_bwd_orders_agree_exactly(cuda):
    """Head-first and block-first give the same bits at head_dim 256, and
    so do reruns."""
    kw = dict(causal=True, window=100, softcap=50.0)
    args = _d256_bwd_case(np.random.default_rng(92), cuda, 8, 4, 2, 700, 700, **kw)
    runs = [fb.flash_attention_bwd(*args, mapping=fa.MappingConfig(order=order), **kw)
            for order in (fa.HEAD_FIRST, fa.BLOCK_FIRST, fa.HEAD_FIRST)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


#: K6's walk forced into these parts at gemma3-1b's heads (group 4 over one
#: kv head), on the ragged causal S and window 100 of D256_BWD.
D256_PARTS = (1, 2, 4)


@pytest.mark.parametrize("parts", D256_PARTS)
@pytest.mark.parametrize("case", ["causal_ragged", "window100"])
def test_d256_flash_bwd_parts_match_plain(cuda, case, parts):
    """K6 at head_dim 256 with its walk in 1, 2 and 4 parts (float32 sums
    of each part added in part order by the second kernel): dK and dV per
    (b, head) slice within 2^-6 of the plain backward; ten reruns, the last
    block-first, bitwise equal to the first; one launch counted; the
    scratch held during the call (more than one part) and freed after it."""
    b, sq, skv, kw = D256_BWD[case]
    q, k, v, o, lse, do = _d256_bwd_case(np.random.default_rng(93), cuda, 4, 1, b, sq, skv,
                                         **kw)
    delta = (do.float() * o.float()).sum(-1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    got = fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, parts=parts, **kw)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    assert counts["flash_attention_bwd_dkv_tc"] == counts["flash_attention_bwd_dkv"] == 1, counts
    scratch = b * -(-skv // 64) * parts * 2 * 64 * 256 * 4   # float32 (B Hkv, nkv, parts, 2, 64, D)
    held = torch.cuda.max_memory_allocated() - before
    outs = sum(g.nbytes for g in got)
    assert held >= outs + scratch if parts > 1 else held == outs, held
    want = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)[1:]
    assert all(g.dtype == torch.bfloat16 and g.shape == w.shape for g, w in zip(got, want))
    assert max(_slice_err(g, w) for g, w in zip(got, want)) <= ROW_TOL
    for order in [fa.HEAD_FIRST] * 9 + [fa.BLOCK_FIRST]:
        again = fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, parts=parts,
                                           mapping=fa.MappingConfig(order=order), **kw)
        assert all(torch.equal(a, g) for a, g in zip(again, got)), order
    del got, want, again
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


def test_d256_flash_bwd_parts_refused_off_the_split(cuda):
    """Only bf16 K6 at head_dim 256 splits its walk: more than one part at
    head_dim 128, or in float32, or fewer than one, raises before a launch."""
    rng = np.random.default_rng(94)
    kernels.reset_launch_counts()
    for dtype, d, parts in ((torch.bfloat16, 128, 2), (torch.float32, 128, 2),
                            (torch.bfloat16, 256, 0)):
        q, k, v, do = (_randn(rng, (1, 4, 130, d), cuda, dtype) for _ in range(4))
        lse = torch.zeros((1, 4, 130), device=cuda)
        with pytest.raises(ValueError, match="parts"):
            fb.flash_attention_bwd_dkv(q, k, v, do, lse, lse, parts=parts)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-1b"])
def test_d256_gemma_train_grads_on_kernels_match_plain(cuda, arch):
    """gemma SMOKE widened to head_dim 256 in bf16 (window 64, seq 100: the
    window bites; gemma2's softcap 50, gemma3's qk-norm): one step's
    gradients through K1 / K5 / K6 against the same step on the plain
    versions, from the same weights and batch. The loss within 1e-2
    relative; each leaf within 3e-2 by its relative norm. At this width
    (d_model 64) bf16 compute alone moves a leaf that far: the plain path in
    bf16 against itself in float32 differed by up to 1.9e-2 (median 1.3e-2)
    on an NVIDIA H100, the kernel path against the plain path by up to
    1.2e-2 (median 0.8e-2); dropping the window moves leaves by 4-17% (the
    plain path on the CPU). The kernels themselves are held per slice at
    2^-6 above."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, make_pipeline

    smoke = {"gemma2-2b": gemma2_2b.SMOKE, "gemma3-1b": gemma3_1b.SMOKE}[arch]
    cfg = dataclasses.replace(smoke, head_dim=256, compute_dtype="bfloat16")
    batch = ts.to_device(make_pipeline(DataConfig(seq_len=100, global_batch=2,
                                                  vocab=cfg.vocab)).batch_at(0), cuda)
    params = transformer.init_model(cfg, seed=0, device=cuda, param_dtype=torch.float32)
    grads, losses = {}, {}
    for impl in ("auto", "plain"):
        kernels.reset_launch_counts()
        g, loss, _ = ts._accumulate_grads(params, dataclasses.replace(cfg, attn_impl=impl),
                                          batch, ts.TrainConfig())
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        grads[impl], losses[impl] = g, float(loss)
        if impl == "auto":   # remat: K1 twice per layer; K5 / K6 once, on the tensor cores
            assert counts["flash_attention_fwd_tc"] == 2 * cfg.n_layers
            assert counts["flash_attention_bwd_dq_tc"] == cfg.n_layers
            assert counts["flash_attention_bwd_dkv_tc"] == cfg.n_layers
        else:
            assert sum(counts.values()) == 0
    assert abs(losses["auto"] - losses["plain"]) <= 1e-2 * abs(losses["plain"])
    for (path, a), b in zip(tree_lib.leaves_with_paths(grads["auto"]),
                            tree_lib.leaves(grads["plain"])):
        assert float((a - b).float().norm() / b.float().norm()) <= 3e-2, path


# -- MoE: moonshot-v1-16b-a3b at full width --------------------------------------

def _moonshot(n_layers=2):
    from repro_torch.configs import moonshot_v1_16b_a3b

    return dataclasses.replace(moonshot_v1_16b_a3b.CONFIG, n_layers=n_layers)


def test_moonshot_fused_decode_ids_agree_across_steps_per_sync(cuda):
    """moonshot-v1-16b-a3b at full width (64 experts top-6, Hq = Hkv = 16,
    D 128), 2 layers, bf16, paged: 5 greedy requests that share a 64-token
    prefix and finish at different lengths, on an engine of 8 rows (frozen
    rows in every tick), at steps_per_sync 1 and 8. The MoE layers run
    inside the captured decode graphs; the ids agree token for token, K1,
    K2 and K3 each launch, all on the tensor cores at a GQA group of 1."""
    cfg = _moonshot()
    params = transformer.init_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(60)
    system = rng.integers(1, cfg.vocab, size=(64,))
    prompts = [np.concatenate([system, rng.integers(1, cfg.vocab, size=(n,))])
               for n in (20, 70, 5, 120, 33)]
    kw = dict(kv_layout="paged", num_pages=128, page_size=16, max_batch=8,
              max_pages_per_seq=16, prompt_buckets=(64, 128, 256))
    ids = {}
    for n in (1, 8):
        kernels.reset_launch_counts()
        eng = LLMEngine(cfg, params, steps_per_sync=n, device=cuda, **kw)
        out = eng.generate([Request(uid=i, prompt=p, max_new_tokens=m)
                            for i, (p, m) in enumerate(zip(prompts, (3, 11, 17, 8, 20)))])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ids[n] = {o.uid: [int(t) for t in o.tokens] for o in out}
        assert eng.backend.stats["decode_traces"] >= 1
        eng.close()
        assert counts["flash_attention_fwd_tc"] > 0 and counts["paged_flash_prefill_tc"] > 0
        assert counts["paged_flash_decode_tc"] + counts["paged_flash_decode_split_tc"] > 0
        assert counts["flash_attention_fwd"] == counts["flash_attention_fwd_tc"]
        assert counts["paged_flash_prefill"] == counts["paged_flash_prefill_tc"]
        assert (counts["paged_flash_decode"] + counts["paged_flash_decode_split"]
                == counts["paged_flash_decode_tc"] + counts["paged_flash_decode_split_tc"])
    assert ids[1] == ids[8]
    assert [len(ids[1][u]) for u in range(5)] == [3, 11, 17, 8, 20]


def test_moe_layer_is_deterministic_eager_and_in_a_graph(cuda):
    """One full-width moonshot MoE FFN (64 experts top-6, D 2048, F 1408),
    bf16: two eager runs over 2 right-padded rows give the same routes and
    the same bits, forward and backward (no float atomics: slots by
    ``index_copy``, the k slots summed in slot order); at the decode shape
    (8 rows, 3 frozen) a captured CUDA graph's replay gives the eager run's
    bits; the frozen rows' values change no live row's output."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.models import moe

    cfg = _moonshot().moe
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    p = moe.init_moe(gen, 2048, cfg, dtype=torch.bfloat16, device=cuda)
    rng = np.random.default_rng(61)
    x = _randn(rng, (2, 700, 2048), cuda, torch.bfloat16)
    valid = torch.zeros((2, 700), dtype=torch.bool, device=cuda)
    valid[0, :650] = True
    valid[1, :300] = True
    routes = []
    inner = moe.route

    def recording(logits, k):
        out = inner(logits, k)
        routes.append(out[2].clone())
        return out

    runs = []
    moe.route = recording
    try:
        for _ in range(2):
            leaves = [t.detach().requires_grad_(True) for t in tree_lib.leaves(p)]
            q = dict(zip(("router", "w_gate", "w_up", "w_down"), leaves))
            xg = x.detach().requires_grad_(True)
            y, aux = moe.moe_ffn(q, xg, cfg, valid=valid)
            (y.float().square().mean() + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
            runs.append([y.detach(), *(aux[key].detach() for key in sorted(aux)), xg.grad,
                         *(t.grad for t in leaves)])
    finally:
        moe.route = inner
    assert torch.equal(routes[0], routes[1])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert float(runs[0][0][~valid].abs().max()) == 0.0      # no slot, no output
    assert torch.isfinite(runs[0][0]).all()

    xd = _randn(rng, (8, 1, 2048), cuda, torch.bfloat16)
    live = torch.tensor([1, 1, 0, 1, 0, 1, 1, 0], dtype=torch.bool, device=cuda)[:, None]
    with torch.no_grad():
        eager, _ = moe.moe_ffn(p, xd, cfg, valid=live)
        noisy = torch.where(live[..., None], xd, 7.0)
        other, _ = moe.moe_ffn(p, noisy, cfg, valid=live)
        static = xd.clone()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            moe.moe_ffn(p, static, cfg, valid=live)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured, _ = moe.moe_ffn(p, static, cfg, valid=live)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    assert torch.equal(eager[live[:, 0]], other[live[:, 0]])


# -- the vision model's forms: K1 / K5 / K6 not causal over image keys, K7 / K8
# -- over a fixed cross stripe ------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sq", [512, 130])
def test_flash_fwd_noncausal_over_1600_image_keys(cuda, dtype, sq):
    """K1 not causal with Sq != Skv over llama-3.2-vision's 1600 image keys
    (12.5 key tiles of 128 on the tensor cores: the last one ragged),
    through ``ops.flash_attention`` as the cross prefill calls it."""
    rng = np.random.default_rng(70)
    dt = DTYPES[dtype]
    q = _randn(rng, (2, 32, sq, 128), cuda, dt)
    k, v = (_randn(rng, (2, 8, 1600, 128), cuda, dt) for _ in range(2))
    kernels.reset_launch_counts()
    o = ops.flash_attention(q, k, v, causal=False)
    counts = kernels.launch_counts()
    o_ref, _ = fa.flash_attention_fwd_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_fwd_tc"] == int(dt == torch.bfloat16)
    assert o.shape == q.shape and _close(o, o_ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sq,skv", [(512, 1600), (300, 1000)])
def test_flash_bwd_noncausal_queries_and_keys_differ(cuda, dtype, sq, skv):
    """K5 / K6 not causal with Sq != Skv: every kv tile walks every q tile,
    and the key tail is ragged."""
    dt = DTYPES[dtype]
    args = _bwd_case(np.random.default_rng(71), cuda, dt, 32, 8, sq, skv, 128, causal=False)
    kernels.reset_launch_counts()
    got = fb.flash_attention_bwd(*args, causal=False)
    counts = kernels.launch_counts()
    want = fb.flash_attention_bwd_plain(*args, causal=False)
    torch.cuda.synchronize()
    assert _bwd_routes(counts, dt), counts
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape, name
        assert _slice_err(g, w) <= GRAD_TOL[dt], name


@pytest.mark.parametrize("num_splits", [1, 4, 7])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_decode_over_a_full_cross_stripe(cuda, num_splits, dtype):
    """K7 / K8 over a cross cache: a stripe of 1600 rows that never grows,
    every row live for every query, at the plan's chunk for that width."""
    rng = np.random.default_rng(72)
    dt = DTYPES[dtype]
    q = _randn(rng, (4, 32, 128), cuda, dt)
    kc, vc = (_randn(rng, (4, 8, 1600, 128), cuda, dt) for _ in range(2))
    lengths = torch.full((4,), 1600, dtype=torch.int32, device=cuda)
    kw = dict(chunk=plan_lib.decode_chunk(1600), num_splits=num_splits)
    kernels.reset_launch_counts()
    o = dd.flash_decode(q, kc, vc, lengths, **kw)
    assert _dense_routes(kernels.launch_counts(), dt)
    ref = dd.flash_decode_plain(q, kc, vc, lengths, **kw)
    torch.cuda.synchronize()
    assert _close(o, ref)


def _vision_cfg():
    """llama-3.2-vision's SMOKE at head_dim 64 (the kernels' smallest),
    float32: held at the float32 bars."""
    return dataclasses.replace(llama_3_2_vision_11b.SMOKE, head_dim=64)


def _open_gates(params, gen):
    for lp in params["layers"]:
        if "cross" in lp:
            lp["cross_gate"] = torch.rand((), generator=gen, device=lp["cross_gate"].device) + 0.5


def test_vision_prefill_and_decode_on_kernels_match_plain(cuda):
    """Prefill with images (K1 causal and not), then 4 decode steps over
    dense stripes and the cross caches (K7 / K8 on both), against the plain
    path on the same weights with the cross gates open: logits within 1e-4
    of the largest."""
    cfg = _vision_cfg()
    params = transformer.init_model(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    _open_gates(params, gen)
    images = torch.randn((2, cfg.vision_tokens, cfg.vision_dim), generator=gen, device=cuda)
    tokens = torch.randint(1, cfg.vocab, (2, 24), generator=gen, device=cuda)
    last = torch.tensor([23, 15], device=cuda)
    n_cross = sum(spec.cross_attn for spec in cfg.layer_specs())
    runs = {}
    for impl in ("auto", "plain"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        kernels.reset_launch_counts()
        logits, caches = transformer.prefill(params, c, tokens, cache_len=32,
                                             image_embeds=images, last_positions=last)
        out = [logits]
        lengths = (last + 1).to(torch.int32)
        tok = logits.argmax(-1)
        for _ in range(4):
            lengths = lengths + 1
            logits, caches = transformer.decode_step(params, c, tok, caches, lengths)
            out.append(logits)
        torch.cuda.synchronize()
        runs[impl] = (out, kernels.launch_counts())
    counts = runs["auto"][1]
    assert counts["flash_attention_fwd"] == cfg.n_layers + n_cross
    assert counts["flash_decode"] + counts["flash_decode_split"] == 4 * (cfg.n_layers + n_cross)
    assert sum(runs["plain"][1].values()) == 0
    for got, want in zip(runs["auto"][0], runs["plain"][0]):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_vision_train_step_on_kernels_matches_plain_path(cuda):
    """One train step with images in 2 microbatches, gates open: gradients
    through K1 / K5 / K6 (the cross layers' not causal) against the same
    step on the plain versions, and the launches the step makes."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, make_pipeline

    cfg = _vision_cfg()
    tcfg = ts.TrainConfig(microbatches=2)
    batch = ts.to_device(make_pipeline(DataConfig(seq_len=100, global_batch=4,
                                                  vocab=cfg.vocab)).batch_at(0), cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    batch["image_embeds"] = torch.randn((4, cfg.vision_tokens, cfg.vision_dim), generator=gen,
                                        device=cuda)
    n_attn = cfg.n_layers + sum(spec.cross_attn for spec in cfg.layer_specs())
    grads, losses = {}, {}
    for impl in ("auto", "plain"):
        params = transformer.init_model(cfg, seed=0, device=cuda, param_dtype=torch.float32)
        gen.manual_seed(3)
        _open_gates(params, gen)
        kernels.reset_launch_counts()
        g, loss, _ = ts._accumulate_grads(params, dataclasses.replace(cfg, attn_impl=impl),
                                          batch, tcfg)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        grads[impl], losses[impl] = g, float(loss)
        if impl == "auto":
            assert counts["flash_attention_fwd"] == 2 * n_attn * 2
            assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] \
                == n_attn * 2
        else:
            assert sum(counts.values()) == 0
    assert abs(losses["auto"] - losses["plain"]) <= 1e-5 * abs(losses["plain"])
    for (path, a), b in zip(tree_lib.leaves_with_paths(grads["auto"]),
                            tree_lib.leaves(grads["plain"])):
        assert float((a - b).norm() / b.norm()) <= 1e-4, path


# -- musicgen-medium: group 1 at head_dim 64, (B, K) token streams --------------

#: musicgen-medium's heads: 24 query heads over 24 KV heads at head_dim 64.
MUSICGEN_HEADS = (24, 24, 64)


def test_musicgen_k1_k5_k6_at_group_one_match_plain(cuda):
    """K1 (causal, ragged S) and K5 / K6 in bf16 at musicgen's heads, group
    1 at D 64, on the tensor cores, against their plain versions."""
    hq, hkv, d = MUSICGEN_HEADS
    rng = np.random.default_rng(70)
    q = _randn(rng, (1, hq, 300, d), cuda, torch.bfloat16)
    k, v = (_randn(rng, (1, hkv, 300, d), cuda, torch.bfloat16) for _ in range(2))
    kernels.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    assert kernels.launch_counts()["flash_attention_fwd_tc"] == 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _close(o, o_ref) and _err(lse, lse_ref) < LSE_TOL
    args = _bwd_case(np.random.default_rng(71), cuda, torch.bfloat16, hq, hkv, 200, 200, d,
                     causal=True)
    kernels.reset_launch_counts()
    got = fb.flash_attention_bwd(*args, causal=True)
    counts = kernels.launch_counts()
    want = fb.flash_attention_bwd_plain(*args, causal=True)
    torch.cuda.synchronize()
    assert _bwd_routes(counts, torch.bfloat16), counts
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _slice_err(g, w) <= GRAD_TOL[torch.bfloat16], name


@pytest.mark.parametrize("num_splits", [1, 2, 4, 7, "plan"])
def test_musicgen_k7_k8_at_group_one_match_plain(cuda, num_splits):
    """K7 / K8 in bf16 at musicgen's heads over 2048-row stripes (the
    tensor-core consumer pads the group of 1 to the MMA's M), with the
    plan's split count among the cases: rows empty, short, mid and full."""
    hq, hkv, d = MUSICGEN_HEADS
    q, kc, vc, _ = _dense_inputs(np.random.default_rng(72), cuda, torch.bfloat16, hq, hkv, d,
                                 2048, b=8)
    lengths = torch.tensor([0, 1, 100, 600, 1000, 1250, 1532, 2048], dtype=torch.int32,
                           device=cuda)
    plan = plan_lib.plan_attention((8, hq, hkv, 1, 2048, d), phase=plan_lib.DECODE,
                                   kv_layout=plan_lib.DENSE, device_type="cuda", dtype_bytes=2)
    kw = dict(chunk=plan.chunk,
              num_splits=plan.num_splits if num_splits == "plan" else num_splits)
    kernels.reset_launch_counts()
    o = dd.flash_decode(q, kc, vc, lengths, **kw)
    assert _dense_routes(kernels.launch_counts(), torch.bfloat16)
    ref = dd.flash_decode_plain(q, kc, vc, lengths, **kw)
    torch.cuda.synchronize()
    assert _close(o, ref)
    assert float(o[0].float().abs().max()) == 0.0


def _musicgen_cfg(dtype="float32"):
    """musicgen SMOKE widened to head_dim 64 (the kernels take 64 and 128)."""
    return dataclasses.replace(musicgen_medium.SMOKE, head_dim=64, compute_dtype=dtype)


def _musicgen_prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(n, cfg.num_codebooks)) for n in lens]


def test_musicgen_engine_on_kernels_matches_plain(cuda):
    """float32, dense (``"auto"``), prompts off the buckets: the kernel
    engine (K1, K7/K8) gives the plain engine's greedy (K,) ids at
    steps_per_sync 1 and 8."""
    cfg = _musicgen_cfg()
    params = transformer.init_model(cfg, seed=0, device=cuda)
    prompts = _musicgen_prompts(cfg, (20, 90, 45, 130), 73)
    kw = dict(max_batch=3, cache_len=256, prompt_buckets=(32, 64, 128, 192), device=cuda)
    tokens = {}
    for impl, steps in (("auto", 1), ("auto", 8), ("plain", 1)):
        eng = LLMEngine(dataclasses.replace(cfg, attn_impl=impl), params,
                        steps_per_sync=steps, **kw)
        assert eng.kv_layout == "dense"
        kernels.reset_launch_counts()
        out = eng.generate([Request(uid=i, prompt=p, max_new_tokens=10)
                            for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        tokens[impl, steps] = {o.uid: np.stack(o.tokens).tolist() for o in out}
        assert all(np.asarray(t).shape == (cfg.num_codebooks,) for o in out for t in o.tokens)
        eng.close()
        if impl == "auto":
            assert counts["flash_attention_fwd"] > 0
            assert counts["flash_decode"] + counts["flash_decode_split"] > 0
        else:
            assert sum(counts.values()) == 0
    assert tokens["auto", 1] == tokens["plain", 1] == tokens["auto", 8]


def test_musicgen_prefill_and_decode_on_kernels_match_plain_in_bf16(cuda):
    """bf16 at the model level: prefill of two rows (one right-padded) and 4
    greedy decode steps over dense stripes on the tensor-core K1 and K7/K8,
    against the plain path on the same weights and tokens: (B, K, V)
    logits within LOGIT_TOL of the plain path's max |logit|."""
    cfg = _musicgen_cfg("bfloat16")
    params = transformer.init_model(cfg, seed=1, device=cuda)
    lens, bucket, cache_len = [40, 27], 64, 128
    tokens = torch.zeros((2, bucket, cfg.num_codebooks), dtype=torch.int64, device=cuda)
    for b, p in enumerate(_musicgen_prompts(cfg, lens, 74)):
        tokens[b, : len(p)] = torch.from_numpy(p)
    last = torch.tensor(lens, device=cuda) - 1
    runs = {}
    for impl in ("plain", "auto"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        kernels.reset_launch_counts()
        logits, caches = transformer.prefill(params, c, tokens, cache_len=cache_len,
                                             last_positions=last)
        seen, lengths = [logits], torch.tensor(lens, dtype=torch.int32, device=cuda)
        tok = runs["plain"][0][0].argmax(-1) if impl == "auto" else logits.argmax(-1)
        for step in range(4):
            lengths = lengths + 1
            logits, caches = transformer.decode_step(params, c, tok, caches, lengths)
            seen.append(logits)
            # Both paths feed the plain path's greedy ids.
            tok = (runs["plain"][0][step + 1] if impl == "auto" else logits).argmax(-1)
        torch.cuda.synchronize()
        runs[impl] = (seen, kernels.launch_counts())
    counts = runs["auto"][1]
    assert counts["flash_attention_fwd_tc"] == cfg.n_layers
    assert counts["flash_decode_tc"] + counts["flash_decode_split_tc"] == 4 * cfg.n_layers
    for got, ref in zip(runs["auto"][0], runs["plain"][0]):
        assert tuple(got.shape) == (2, cfg.num_codebooks, cfg.vocab)
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= LOGIT_TOL * float(ref.abs().max())


def test_musicgen_fused_graph_tokens_match_eager_ticks(cuda):
    """bf16, dense, steps_per_sync 8, one greedy and one sampled request: the
    8-tick graph's (rows, K) fed and sampled tokens and masks equal those of
    the same tick function run eagerly on the same inputs, and its last
    logits lie within LOGIT_TOL of the eager ones; the one-tick graph
    engine gives the same ids."""
    from repro_torch.serving import SamplingParams

    cfg = _musicgen_cfg("bfloat16")
    params = transformer.init_model(cfg, seed=2, device=cuda)
    prompts = _musicgen_prompts(cfg, (21, 40), 75)
    sampled = SamplingParams(temperature=1.0, top_k=250, max_tokens=17, seed=4)
    kw = dict(max_batch=3, cache_len=128, prompt_buckets=(32, 64), device=cuda)
    ids = {}
    for n in (8, 1):
        eng = LLMEngine(cfg, params, steps_per_sync=n, **kw)
        eng.add_request(Request(uid=0, prompt=prompts[0], max_new_tokens=17))
        eng.add_request(Request(uid=1, prompt=prompts[1], sampling=sampled))
        out = {o.uid: o for o in eng.step() if o.finished}
        if n == 8:
            program = eng.backend._programs[(8, 0)]
            assert program.graph is not None
            graph_out, graph_logits = program.out.clone(), program.logits.clone()
            program.graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(program.out, graph_out)
            eager_out, eager_logits = program.run()
            torch.cuda.synchronize()
            assert torch.equal(eager_out, graph_out)
            assert tuple(graph_logits.shape) == (3, cfg.num_codebooks, cfg.vocab)
            diff = float((graph_logits - eager_logits).float().abs().max())
            assert diff <= LOGIT_TOL * float(eager_logits.float().abs().max())
        while eng.backend.active.any() or eng.scheduler.has_work():
            out.update({o.uid: o for o in eng.step() if o.finished})
        ids[n] = {u: np.stack(o.tokens).tolist() for u, o in out.items()}
        assert all(p.graph is not None for p in eng.backend._programs.values())
        eng.close()
    assert ids[8] == ids[1]
    assert all(len(t) == 17 for t in ids[8].values())


def test_musicgen_train_step_on_kernels_matches_plain_path(cuda):
    """float32, (B, S, K) codes in 2 microbatches: one step's gradients
    through K1 / K5 / K6 against the same step on the plain versions, and
    the launches the step makes."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, make_pipeline

    cfg = _musicgen_cfg()
    tcfg = ts.TrainConfig(microbatches=2)
    batch = ts.to_device(make_pipeline(DataConfig(
        seq_len=100, global_batch=4, vocab=cfg.vocab,
        num_codebooks=cfg.num_codebooks)).batch_at(0), cuda)
    grads, losses = {}, {}
    for impl in ("auto", "plain"):
        params = transformer.init_model(cfg, seed=0, device=cuda, param_dtype=torch.float32)
        kernels.reset_launch_counts()
        g, loss, _ = ts._accumulate_grads(params, dataclasses.replace(cfg, attn_impl=impl),
                                          batch, tcfg)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        grads[impl], losses[impl] = g, float(loss)
        if impl == "auto":
            assert counts["flash_attention_fwd"] == 2 * cfg.n_layers * 2
            assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] \
                == cfg.n_layers * 2
        else:
            assert sum(counts.values()) == 0
    assert abs(losses["auto"] - losses["plain"]) <= 1e-5 * abs(losses["plain"])
    for (path, a), b in zip(tree_lib.leaves_with_paths(grads["auto"]),
                            tree_lib.leaves(grads["plain"])):
        assert float((a - b).norm() / b.norm()) <= 1e-4, path


# -- mixtral-8x7b: group 4 at head_dim 128 under a 4096 window that bites -------

#: mixtral's heads (Hq 32, Hkv 8, D 128) and window.
MIXTRAL = dict(hq=32, hkv=8, d=128, window=4096)


def _windowed_table(rng, dev, b, mp, frozen=()):
    """A scattered (b, mp) page table over 1 + b * mp pages, the rows in
    ``frozen`` all on the null page 0."""
    table = rng.permutation(np.arange(1, 1 + b * mp)).reshape(b, mp).astype(np.int32)
    table[list(frozen)] = 0
    return torch.from_numpy(table).to(dev)


@pytest.mark.parametrize("plen,window", [(5000, 4096), (1500, 700)],
                         ids=["prefix5000_window4096", "prefix1500_window700"])
def test_mixtral_windowed_paged_prefill_matches_plain(cuda, plen, window):
    """K2 at mixtral's heads, bf16, pages of 16: three rows over prefixes of
    ``plen`` keys, tails of 256, 219 and 0 (a row with nothing to prefill).
    Tail row i sits at plen + i and sees keys from plen + i - window + 1 on,
    inside the prefix, so the walk starts on a page mid-prefix and masks
    both at the window's edge and at the diagonal. Held per row within
    2^-6; rows past tail_len exact zeros; 10 reruns bitwise equal."""
    rng = np.random.default_rng(380)
    hq, hkv, d = MIXTRAL["hq"], MIXTRAL["hkv"], MIXTRAL["d"]
    b, st, ps = 3, 256, 16
    mp = -(-plen // ps)
    q = _randn(rng, (b, hq, st, d), cuda, torch.bfloat16)
    kt, vt = (_randn(rng, (b, hkv, st, d), cuda, torch.bfloat16) for _ in range(2))
    kp, vp = (_randn(rng, (hkv, 1 + b * mp, ps, d), cuda, torch.bfloat16) for _ in range(2))
    args = (q, kp, vp, _windowed_table(rng, cuda, b, mp), kt, vt,
            torch.full((b,), plen, dtype=torch.int32, device=cuda),
            torch.tensor([256, 219, 0], dtype=torch.int32, device=cuda))
    kernels.reset_launch_counts()
    o = pp.paged_flash_prefill(*args, window=window)
    assert _prefill_routes(kernels.launch_counts(), torch.bfloat16)
    o_ref = pp.paged_flash_prefill_plain(*args, window=window)
    torch.cuda.synchronize()
    assert _row_err(o, o_ref) < ROW_TOL
    for bi, t in enumerate((256, 219, 0)):
        assert float(o[bi, :, t:].float().abs().sum()) == 0.0
    assert all(torch.equal(pp.paged_flash_prefill(*args, window=window), o) for _ in range(10))


@pytest.mark.parametrize("num_splits", [1, 4, 9])
def test_mixtral_windowed_paged_decode_matches_plain(cuda, num_splits):
    """K3 / K4 at mixtral's heads, bf16, over 392-page tables (run (b)'s
    engine): rows of 6144 (its first 2048 keys before the window: at 9
    splits of 44 pages splits 0 and 1 hold no live key), 4000, 100 and 0
    tokens, and a row frozen on the null page at 3000. Held per row within
    2^-6; the length-0 row exact zeros; 10 reruns bitwise equal."""
    rng = np.random.default_rng(381)
    hq, hkv, d, window = (MIXTRAL[k] for k in ("hq", "hkv", "d", "window"))
    lens, mp, ps = [6144, 3000, 4000, 100, 0], 392, 16
    q = _randn(rng, (len(lens), hq, d), cuda, torch.bfloat16)
    kp, vp = (_randn(rng, (hkv, 1 + len(lens) * mp, ps, d), cuda, torch.bfloat16)
              for _ in range(2))
    args = (q, kp, vp, _windowed_table(rng, cuda, len(lens), mp, frozen=(1,)),
            torch.tensor(lens, dtype=torch.int32, device=cuda))
    kw = dict(window=window, num_splits=num_splits)
    kernels.reset_launch_counts()
    o = pd.paged_flash_decode(*args, **kw)
    assert _paged_routes(kernels.launch_counts(), torch.bfloat16)
    o_ref = pd.paged_flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _row_err(o, o_ref) < ROW_TOL
    assert float(o[4].float().abs().max()) == 0.0
    assert all(torch.equal(pd.paged_flash_decode(*args, **kw), o) for _ in range(10))


def test_mixtral_empty_splits_in_a_graph_write_their_state(cuda):
    """K4 at mixtral's heads, 9 splits over 392 pages, captured in a CUDA
    graph as the fused decode captures it: its split workspace keeps the
    last replay's states. A replay at 4000 tokens (every split up to the
    row's end live) fills splits 0 and 1; a replay at 6144 leaves them
    before the window, so each must write (0, -1e30, 0) over them, or the
    combine would take 4000's states. A row frozen on the null page beside
    it. Each replay held per row within 2^-6 of the plain version."""
    rng = np.random.default_rng(382)
    hq, hkv, d, window = (MIXTRAL[k] for k in ("hq", "hkv", "d", "window"))
    mp, ps = 392, 16
    q = _randn(rng, (2, hq, d), cuda, torch.bfloat16)
    kp, vp = (_randn(rng, (hkv, 1 + 2 * mp, ps, d), cuda, torch.bfloat16) for _ in range(2))
    table = _windowed_table(rng, cuda, 2, mp, frozen=(1,))
    lengths = torch.tensor([4000, 3000], dtype=torch.int32, device=cuda)
    kw = dict(window=window, num_splits=9)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pd.paged_flash_decode(q, kp, vp, table, lengths, **kw)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o = pd.paged_flash_decode(q, kp, vp, table, lengths, **kw)
    for n in (4000, 6144, 4000, 6144):
        lengths[0] = n
        graph.replay()
        o_ref = pd.paged_flash_decode_plain(q, kp, vp, table, lengths, **kw)
        torch.cuda.synchronize()
        assert _row_err(o, o_ref) < ROW_TOL, n


@pytest.mark.parametrize("s,window", [(4608, 4096), (1280, 300)],
                         ids=["s4608_window4096", "s1280_window300"])
def test_mixtral_windowed_k1_k5_k6_match_plain(cuda, s, window):
    """K1, K5 and K6 at mixtral's heads (group 4, D 128), bf16, causal under
    a window shorter than the sequence: for a key block the live query rows
    end at key + window, so K6's walk stops before the last row tile. o per
    row, lse within 1e-5, dq / dk / dv per (b, head) slice within 2^-6 of
    the plain versions; the block-first order gives the head-first bits."""
    rng = np.random.default_rng(383)
    hq, hkv, d = MIXTRAL["hq"], MIXTRAL["hkv"], MIXTRAL["d"]
    q, do = (_randn(rng, (1, hq, s, d), cuda, torch.bfloat16) for _ in range(2))
    k, v = (_randn(rng, (1, hkv, s, d), cuda, torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, window=window)
    kernels.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
    got = {}
    for order in (fa.HEAD_FIRST, fa.BLOCK_FIRST):
        got[order] = fb.flash_attention_bwd(q, k, v, o, lse, do,
                                            mapping=fa.MappingConfig(order=order), **kw)
    counts = kernels.launch_counts()
    want = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert counts["flash_attention_fwd_tc"] == counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dq_tc"] == counts["flash_attention_bwd_dkv_tc"] == 2
    assert _row_err(o, o_ref) < ROW_TOL and _err(lse, lse_ref) < LSE_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got[fa.HEAD_FIRST], want):
        assert _slice_err(g, w) <= ROW_TOL, name
    assert all(torch.equal(a, b) for a, b in zip(got[fa.HEAD_FIRST], got[fa.BLOCK_FIRST]))
