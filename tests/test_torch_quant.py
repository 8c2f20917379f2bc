"""Quantized KV pools of the PyTorch port against the JAX package, on the CPU.

``repro_torch.cache.quant`` against ``repro.cache.quant`` on the same numpy
inputs (int8 codes equal exactly, fp8 codes equal as values, scales within
one float32 ulp), the quantized plain versions of K3, K4 and K2 against the
JAX Pallas kernels in interpret mode (2e-5, the JAX suite's bar in
``tests/test_tiering.py``) and against the unquantized oracle within the
format's budget (``QTOL``, the same file's), and the port's engine with
``kv_dtype`` "int8" / "fp8" against the JAX engine's greedy ids on the llama
SMOKE config, gemma2-2b's over int8 and gemma3-1b's over fp8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import quant as jax_quant
from repro.configs import gemma2_2b as jax_gemma2
from repro.configs import gemma3_1b as jax_gemma3
from repro.configs import llama3_8b as jax_llama
from repro.kernels.paged_decode_attention import paged_flash_decode as jax_decode
from repro.kernels.paged_prefill_attention import paged_flash_prefill as jax_prefill
from repro.models import transformer as jax_tf
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling

from repro_torch.cache import quant
from repro_torch.configs import gemma2_2b, gemma3_1b, llama3_8b
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_decode_attention import (
    paged_flash_decode,
    paged_flash_decode_plain,
)
from repro_torch.kernels.paged_prefill_attention import (
    paged_flash_prefill,
    paged_flash_prefill_plain,
)
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request, SamplingParams

F32_TOL = 2e-5
#: Worst-case |dequant(quant(x)) - x| through attention, per format
#: (tests/test_tiering.py's QTOL).
QTOL = {"int8": 0.03, "fp8": 0.12}
KV_DTYPES = ["int8", "fp8"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _both_quantized(x: np.ndarray, kv_dtype):
    """``x`` quantized by both packages: (JAX codes, JAX scales, port codes,
    port scales)."""
    jc, js = jax_quant.quantize_pages(jnp.asarray(x), kv_dtype)
    tc, ts = quant.quantize_pages(torch.from_numpy(x), kv_dtype)
    return jc, js, tc, ts


# -- cache.quant ---------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantize_pages_matches_jax(kv_dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 8, 16)) * rng.uniform(0.1, 9, (3, 7, 1, 1))).astype(
        np.float32)
    x[1, 2] = 0.0                                     # an all-zero page: scale 0, codes 0
    jc, js, tc, ts = _both_quantized(x, kv_dtype)
    assert tc.dtype == quant.storage_dtype(kv_dtype)
    assert np.array_equal(_jnp(jc), _np(tc))
    ulps = np.abs(np.asarray(js).view(np.int32) - ts.numpy().view(np.int32))
    assert ulps.max() <= 1
    assert float(ts[1, 2]) == 0.0 and float(tc[1, 2].float().abs().max()) == 0.0
    assert np.array_equal(_jnp(jax_quant.dequantize_pages(jc, js)),
                          _np(quant.dequantize_pages(tc, ts)))
    if kv_dtype == "int8":
        assert int(tc.abs().max()) <= 127


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_append_scatter_cow_match_jax(kv_dtype):
    """One decode append (a loud row rescales its page), a tail scatter and
    a copy-on-write, each on both packages from the same state."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    jc, js, tc, ts = _both_quantized(x, kv_dtype)
    rows = (rng.standard_normal((2, 3, 16)) * np.array([1, 40, 0.1])[None, :, None]).astype(
        np.float32)
    pids, offs = np.array([4, 1, 2], np.int32), np.array([3, 7, 0], np.int32)
    jc, js = jax_quant.append_rows(jc, js, jnp.asarray(rows), jnp.asarray(pids),
                                   jnp.asarray(offs), kv_dtype)
    out = quant.append_rows(tc, ts, torch.from_numpy(rows), torch.from_numpy(pids),
                            torch.from_numpy(offs), kv_dtype)
    assert out[0] is tc and out[1] is ts              # in place
    assert np.array_equal(_jnp(jc), _np(tc))
    assert np.array_equal(np.asarray(js), ts.numpy())
    new = rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
    jc, js = jax_quant.scatter_pages(jc, js, jnp.asarray(new), jnp.asarray([5, 3]), kv_dtype)
    quant.scatter_pages(tc, ts, torch.from_numpy(new), torch.tensor([5, 3]), kv_dtype)
    assert np.array_equal(_jnp(jc), _np(tc))
    assert np.array_equal(np.asarray(js), ts.numpy())
    js = jax_quant.cow_scales(js, 5, 0)
    quant.cow_scales(ts, 5, 0)
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert quant.cow_scales(None, 1, 2) is None


def test_append_rows_rescale_keeps_history():
    """tests/test_tiering.py's rescale-on-append bars, on the port: a loud
    new token widens its page's scale and shrinks the existing codes; the
    history dequantizes within one new quantization step."""
    rng = np.random.default_rng(0)
    hkv, P, ps, d = 2, 3, 8, 16
    x = rng.standard_normal((hkv, P, ps, d)).astype(np.float32)
    pages, scales = quant.quantize_pages(torch.from_numpy(x), "int8")
    before = quant.dequantize_pages(pages, scales)
    loud = torch.from_numpy((50.0 * rng.standard_normal((hkv, 1, d))).astype(np.float32))
    quant.append_rows(pages, scales, loud, torch.tensor([1]), torch.tensor([3]), "int8")
    after = quant.dequantize_pages(pages, scales)
    assert float((after[:, 1, 3] - loud[:, 0]).abs().max()) < float(loud.abs().max()) / 127 * 1.01
    assert torch.equal(after[:, 0], before[:, 0]) and torch.equal(after[:, 2], before[:, 2])
    rest = [i for i in range(ps) if i != 3]
    step = float(scales[:, 1].max())
    assert float((after[:, 1, rest] - before[:, 1, rest]).abs().max()) <= step * 1.01


def test_fp32_scheme_is_the_plain_store():
    pages = torch.zeros(2, 4, 8, 16, dtype=torch.bfloat16)
    rows = torch.randn(2, 2, 16)
    quant.append_rows(pages, None, rows, torch.tensor([1, 3]), torch.tensor([0, 5]), "fp32")
    assert torch.equal(pages[:, 1, 0], rows[:, 0].to(torch.bfloat16))
    assert quant.kv_dtype_of(torch.bfloat16) == "fp32" and quant.kv_itemsize("int8") == 1
    assert quant.scale_nbytes(8, 10, "fp8") == 320 and quant.scale_nbytes(8, 10, "fp32") == 0
    with pytest.raises(ValueError, match="kv_dtype"):
        quant.validate_kv_dtype("int4")


# -- K3 / K4 / K2 over quantized pools -----------------------------------------


def _paged(rng, b, hq, hkv, d, ps, max_pages, shared_pages=0):
    """tests/test_tiering.py's mk_paged, from numpy: non-page-multiple
    lengths, a shared prefix of pages, scattered tables."""
    num_pages = 1 + shared_pages + b * max_pages
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    avail = list(rng.permutation(np.arange(1 + shared_pages, num_pages)))
    table = np.zeros((b, max_pages), np.int32)
    lengths = np.zeros((b,), np.int32)
    for i in range(b):
        lengths[i] = rng.integers(max(shared_pages * ps, 1), max_pages * ps + 1)
        live = -(-int(lengths[i]) // ps)
        row = list(range(1, 1 + min(shared_pages, live)))
        row += [avail.pop() for _ in range(live - len(row))]
        table[i, :live] = row
    return q, kp, vp, table, lengths


def _decode_both(q, kp, vp, table, lengths, kv_dtype, **kw):
    """K3/K4 over the quantized pools on both packages: (JAX kernel, port,
    port's unquantized oracle on the float32 pools)."""
    jk, jks, tk, tks = _both_quantized(kp, kv_dtype)
    jv, jvs, tv, tvs = _both_quantized(vp, kv_dtype)
    oj = jax_decode(jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                    k_scales=jks, v_scales=jvs, interpret=True, **kw)
    tq, tt, tl = torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(lengths)
    ot = paged_flash_decode(tq, tk, tv, tt, tl, k_scales=tks, v_scales=tvs, **kw)
    o32 = ref.paged_decode_attention(tq, torch.from_numpy(kp), torch.from_numpy(vp), tt, tl)
    oq = ref.paged_decode_attention(tq, tk, tv, tt, tl, k_scales=tks, v_scales=tvs)
    return np.asarray(oj), ot, o32, oq


@pytest.mark.parametrize("b,hq,hkv,d", [(2, 8, 2, 64), (2, 4, 1, 64), (1, 25, 5, 64)],
                         ids=["gqa", "mqa", "odd_group"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_decode_matches_jax(b, hq, hkv, d, kv_dtype):
    rng = np.random.default_rng(hq + hkv)
    args = _paged(rng, b, hq, hkv, d, ps=16, max_pages=6, shared_pages=2)
    oj, ot, o32, oq = _decode_both(*args, kv_dtype)
    assert _diff(oj, _np(ot)) < F32_TOL
    assert _diff(_np(oq), _np(ot)) < F32_TOL
    assert _diff(_np(o32), _np(ot)) < QTOL[kv_dtype]


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_decode_split_k_matches_jax(kv_dtype):
    rng = np.random.default_rng(5)
    args = _paged(rng, 2, 8, 2, 64, ps=16, max_pages=8)
    oj, ot, o32, _ = _decode_both(*args, kv_dtype, num_splits=4)
    assert _diff(oj, _np(ot)) < F32_TOL
    assert _diff(_np(o32), _np(ot)) < QTOL[kv_dtype]
    one = _decode_both(*args, kv_dtype)[1]
    assert _diff(_np(one), _np(ot)) < F32_TOL


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_decode_length_zero_row(kv_dtype):
    rng = np.random.default_rng(3)
    q, kp, vp, table, lengths = _paged(rng, 3, 8, 2, 64, ps=16, max_pages=4)
    lengths[1] = 0
    oj, ot, o32, _ = _decode_both(q, kp, vp, table, lengths, kv_dtype)
    assert float(ot[1].abs().max()) == 0.0 and float(np.abs(oj[1]).max()) == 0.0
    assert _diff(oj, _np(ot)) < F32_TOL
    assert _diff(_np(o32), _np(ot)) < QTOL[kv_dtype]


def test_quantized_decode_null_page_garbage_stays_out():
    """Rows frozen on the null page write garbage there (the fused decode);
    a NaN scale or NaN codes on it must not reach a live row, whose table
    pads with the null page past its live pages. The plain walk removes
    masked positions by select, so live rows keep the clean pool's bits."""
    rng = np.random.default_rng(11)
    q, kp, vp, table, lengths = _paged(rng, 4, 8, 2, 64, ps=16, max_pages=5)
    codes, tq = {}, torch.from_numpy(q)
    for name, x in (("k", kp), ("v", vp)):
        codes[name] = quant.quantize_pages(torch.from_numpy(x), "fp8")
    tt, tl = torch.from_numpy(table), torch.from_numpy(lengths)
    clean = paged_flash_decode(tq, codes["k"][0], codes["v"][0], tt, tl,
                               k_scales=codes["k"][1], v_scales=codes["v"][1])
    for name in ("k", "v"):
        quant.put_pages(codes[name][0], (slice(None), 0),
                        torch.full((2, 16, 64), float("nan")).to(torch.float8_e4m3fn))
        codes[name][1][:, 0] = float("nan")
    for ns in (1, 3):
        o = paged_flash_decode_plain(tq, codes["k"][0], codes["v"][0], tt, tl,
                                     k_scales=codes["k"][1], v_scales=codes["v"][1],
                                     num_splits=ns)
        assert torch.isfinite(o).all()
        assert _diff(_np(clean), _np(o)) < F32_TOL


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_prefill_matches_jax(kv_dtype):
    """Extend prefill over quantized prefix pages and a fresh float32 tail:
    port vs the JAX kernel (float eps) vs the fp32 oracle (format budget);
    non-page-multiple prefixes; rows past tail_len exactly zero."""
    rng = np.random.default_rng(7)
    b, hq, hkv, d, ps, mp, st = 2, 8, 2, 64, 16, 4, 24
    q = rng.standard_normal((b, hq, st, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, 1 + b * mp, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, 1 + b * mp, ps, d)).astype(np.float32)
    kt = rng.standard_normal((b, hkv, st, d)).astype(np.float32)
    vt = rng.standard_normal((b, hkv, st, d)).astype(np.float32)
    table = (1 + np.arange(b * mp).reshape(b, mp)).astype(np.int32)
    plen, tlen = np.array([37, 64], np.int32), np.array([st, st - 5], np.int32)
    jk, jks, tk, tks = _both_quantized(kp, kv_dtype)
    jv, jvs, tv, tvs = _both_quantized(vp, kv_dtype)
    oj = jax_prefill(jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(kt),
                     jnp.asarray(vt), jnp.asarray(plen), jnp.asarray(tlen),
                     k_scales=jks, v_scales=jvs, interpret=True)
    targs = [torch.from_numpy(a) for a in (q, table, kt, vt, plen, tlen)]
    tq, tt, tkt, tvt, tp, tl = targs
    ot = paged_flash_prefill(tq, tk, tv, tt, tkt, tvt, tp, tl, k_scales=tks, v_scales=tvs)
    assert _diff(np.asarray(oj), _np(ot)) < F32_TOL
    oq = ref.paged_prefill_attention(tq, tk, tv, tt, tkt, tvt, tp, tl, k_scales=tks,
                                     v_scales=tvs)
    assert _diff(_np(oq), _np(ot)) < F32_TOL
    o32 = ref.paged_prefill_attention(tq, torch.from_numpy(kp), torch.from_numpy(vp), tt,
                                      tkt, tvt, tp, tl)
    assert _diff(_np(o32), _np(ot)) < QTOL[kv_dtype]
    assert float(ot[1, :, st - 5:].abs().max()) == 0.0
    via_ops = ops.paged_prefill_attention(tq, tk, tv, tt, tkt, tvt, tp, tl, k_scales=tks,
                                          v_scales=tvs)
    assert torch.equal(via_ops, ot)


def test_scales_both_or_neither_everywhere():
    """One-sided scales would attend over raw codes: every dispatch target
    (wrapper, plain version, oracle, decode and prefill) refuses them."""
    rng = np.random.default_rng(0)
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _paged(rng, 1, 4, 2, 32, ps=8, max_pages=2))
    kq, ksc = quant.quantize_pages(kp, "int8")
    for fn in (paged_flash_decode, paged_flash_decode_plain, ref.paged_decode_attention):
        with pytest.raises(ValueError, match="together"):
            fn(q, kq, kq, table, lengths, k_scales=ksc)
        with pytest.raises(ValueError, match="together"):
            fn(q, kq, kq, table, lengths, v_scales=ksc)
    qp, tail = torch.zeros(1, 4, 8, 32), torch.zeros(1, 2, 8, 32)
    eight = torch.tensor([8], dtype=torch.int32)
    for fn in (paged_flash_prefill, paged_flash_prefill_plain, ref.paged_prefill_attention):
        with pytest.raises(ValueError, match="together"):
            fn(qp, kq, kq, table, tail, tail, eight, eight, v_scales=ksc)


# -- the model and the engine -------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                         llama3_8b.SMOKE, device="cpu")
    return jparams, params


def _prompts():
    """tests/test_tiering.py's int8 acceptance prompts."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, 400, size=n) for n in (8, 17, 25, 33)]


def _port_ids(params, prompts, n_new=8, cfg=llama3_8b.SMOKE, **kw):
    eng = LLMEngine(cfg, params, kv_layout="paged", num_pages=64, page_size=8,
                    device="cpu", **kw)
    out = eng.generate([Request(uid=i, prompt=p, sampling=SamplingParams(max_tokens=n_new))
                        for i, p in enumerate(prompts)])
    stats = eng.backend.prefix_stats()
    eng.close()
    return {o.uid: [int(t) for t in o.tokens] for o in out}, stats


def _gemma_models(arch):
    """The JAX SMOKE weights of ``arch`` (seeded as tests/test_torch_gemma.py
    seeds them) and the port's copy of them."""
    jmod, tmod = {"gemma2-2b": (jax_gemma2, gemma2_2b), "gemma3-1b": (jax_gemma3, gemma3_1b)}[arch]
    tree = jax.tree.map(np.asarray, jax_tf.init_model(jax.random.PRNGKey(3), jmod.SMOKE))
    return (jmod.SMOKE, jax.tree.map(jnp.asarray, tree), tmod.SMOKE,
            transformer.from_jax_params(tree, tmod.SMOKE, device="cpu"))


@pytest.mark.parametrize("arch,kv_dtype", [
    pytest.param("llama3-8b", "int8", id="int8"), pytest.param("llama3-8b", "fp8", id="fp8"),
    pytest.param("gemma2-2b", "int8", id="gemma2-2b-int8"),
    pytest.param("gemma3-1b", "fp8", id="gemma3-1b-fp8")])
def test_quantized_engine_matches_jax_engine(models, arch, kv_dtype):
    """The port's CPU engine over a quantized pool against the JAX engine,
    greedy ids token for token: llama3-8b SMOKE in both formats, gemma2-2b
    SMOKE (softcaps, alternating local and global layers) over int8 and
    gemma3-1b SMOKE (qk-norm, one kv head) over fp8, 4 new tokens on the
    first two prompts (the JAX engine's compiles take most of a case's
    time)."""
    prompts, n_new = _prompts(), 8
    if arch == "llama3-8b":
        (jparams, params), jcfg, cfg = models, jax_llama.SMOKE, llama3_8b.SMOKE
    else:
        jcfg, jparams, cfg, params = _gemma_models(arch)
        prompts, n_new = prompts[:2], 4
    jeng = JaxEngine(jcfg, jparams, kv_layout="paged", num_pages=64, page_size=8,
                     kv_dtype=kv_dtype)
    jout = jeng.generate([JaxRequest(uid=i, prompt=p, sampling=JaxSampling(max_tokens=n_new))
                          for i, p in enumerate(prompts)])
    jeng.close()
    want = {o.uid: [int(t) for t in o.tokens] for o in jout}
    got, stats = _port_ids(params, prompts, n_new=n_new, kv_dtype=kv_dtype, cfg=cfg)
    assert got == want
    assert stats["kv_dtype"] == kv_dtype
    if arch == "llama3-8b" and kv_dtype == "int8":
        # tests/test_tiering.py's acceptance: int8 noise flips no greedy
        # argmax on these prompts.
        assert _port_ids(params, prompts)[0] == got


def test_int8_ids_same_at_steps_per_sync_1_and_8(models):
    _, params = models
    prompts = _prompts()
    one = _port_ids(params, prompts, n_new=12, kv_dtype="int8", steps_per_sync=1)[0]
    eight = _port_ids(params, prompts, n_new=12, kv_dtype="int8", steps_per_sync=8)[0]
    assert one == eight


def test_quantized_pool_bytes(models):
    """Pool bytes with the scale tables, exact: <= 0.55x a float32 pool
    (the JAX bar), and at page 16, D 128 <= 0.51x a bf16 pool."""
    _, params = models
    cfg = llama3_8b.SMOKE
    sizes = {}
    for kv_dtype in ("fp32", "int8", "fp8"):
        eng = LLMEngine(cfg, params, kv_layout="paged", num_pages=32, page_size=8,
                        kv_dtype=kv_dtype, device="cpu")
        sizes[kv_dtype] = eng.backend.kv_pool_bytes()
        held = sum(t.numel() * t.element_size() for c in eng.backend.caches for t in c.values())
        assert sizes[kv_dtype] == held
        item, scale = (4, 0) if kv_dtype == "fp32" else (1, 4)     # SMOKE computes in float32
        assert held == 2 * cfg.n_layers * cfg.n_kv_heads * (8 * cfg.head_dim * item + scale) * 32
        eng.close()
    assert sizes["int8"] == sizes["fp8"] <= 0.55 * sizes["fp32"]
    # llama3-8b's head_dim and the card's bf16 pool, at page 16.
    wide = dataclasses.replace(cfg, head_dim=128, compute_dtype="bfloat16")
    wide_params = transformer.init_model(wide, seed=0, device="cpu")
    wide_sizes = {}
    for kv_dtype in ("fp32", "int8"):
        eng = LLMEngine(wide, wide_params, kv_layout="paged", num_pages=8, page_size=16,
                        max_pages_per_seq=4, kv_dtype=kv_dtype, device="cpu")
        wide_sizes[kv_dtype] = eng.backend.kv_pool_bytes()
        eng.close()
    assert wide_sizes["int8"] <= 0.51 * wide_sizes["fp32"]


def test_quantized_needs_the_paged_layout(models):
    _, params = models
    with pytest.raises(ValueError, match="paged"):
        LLMEngine(llama3_8b.SMOKE, params, kv_layout="dense", kv_dtype="int8", device="cpu")
    eng = LLMEngine(llama3_8b.SMOKE, params, kv_dtype="fp8", device="cpu")
    assert eng.kv_layout == "paged"
    assert eng.backend.caches[0]["k_pages"].dtype == torch.float8_e4m3fn
    eng.close()
