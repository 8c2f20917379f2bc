"""The extend routes of the PyTorch port against the JAX package, on the CPU:
K1's per-row query offsets (its plain version against ``ref.attention
(q_offset=)``), the dense extend (``ops.flash_attention(q_offset=)``), the
paged extend's gather route and K2's plain path against
``ref.paged_prefill_attention`` over float32, int8 and fp8 pools, the
extend-route scorer against the JAX plan's on the JAX presets, and the
route pinned through a paged engine."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import quant as jax_quant
from repro.configs import llama3_8b as jax_llama
from repro.core import numa as jax_numa
from repro.core import perf_model as jax_pm
from repro.kernels import ops as jax_ops
from repro.kernels import plan as jax_plan
from repro.kernels import ref as jax_ref
from repro.models import transformer as jax_tf

from repro_torch.cache import quant
from repro_torch.configs import llama3_8b
from repro_torch.core import numa, perf_model
from repro_torch.kernels import ops
from repro_torch.kernels import paged_prefill_attention as pp
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request

F32_TOL = 2e-5
REL = 1e-12
HEADS = [(4, 2), (4, 4), (4, 1)]          # GQA, MHA, MQA
HEAD_IDS = ["gqa", "mha", "mqa"]


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


# -- K1 with per-row query offsets -------------------------------------------------


@pytest.mark.parametrize("hq,hkv", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 30.0)],
                         ids=["causal", "window_softcap"])
def test_k1_offsets_match_jax_ref(hq, hkv, window, softcap):
    """Ragged rows: offsets 0, 23 and 80 over 120 keys, each row its own
    kv_len (the second 4 keys short of its last query, so its last rows see
    fewer keys than causality allows). Each row against ``ref.attention``
    at its offset over its live keys, o and lse to 2e-5."""
    rng = np.random.default_rng(hq * 3 + hkv)
    q = _normal(rng, 3, hq, 40, 16)
    k, v = _normal(rng, 3, hkv, 120, 16), _normal(rng, 3, hkv, 120, 16)
    off, kv_len = [0, 23, 80], [40, 59, 120]
    o, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=True, window=window, softcap=softcap,
                                 q_offset=torch.tensor(off, dtype=torch.int32),
                                 kv_len=torch.tensor(kv_len, dtype=torch.int32))
    for i, (o_i, n) in enumerate(zip(off, kv_len)):
        args = (q[i:i + 1], k[i:i + 1, :, :n], v[i:i + 1, :, :n])
        kw = dict(causal=True, window=window, softcap=softcap, q_offset=o_i)
        assert _diff(jax_ref.attention(*args, **kw), o[i:i + 1]) < F32_TOL
        assert _diff(jax_ref.attention_lse(*args, **kw), lse[i:i + 1]) < F32_TOL


def test_k1_int_offset_equals_per_row_and_zero_equals_none():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(_normal(rng, 2, h, n, 16)) for h, n in ((4, 24), (2, 60), (2, 60)))
    a = flash_attention_fwd(q, k, v, q_offset=36)
    b = flash_attention_fwd(q, k, v, q_offset=torch.tensor([36, 36]), kv_len=60)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(flash_attention_fwd(q, k, v, q_offset=0),
                                                 flash_attention_fwd(q, k, v)))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, q_offset=torch.tensor([1, 2, 3]))


@pytest.mark.parametrize("window", [None, 17])
def test_dense_extend_matches_jax(window):
    """``ops.flash_attention(q_offset=)``, the dense extend, against the
    JAX package's on the same inputs; its plan is phase EXTEND."""
    rng = np.random.default_rng(4)
    q, k, v = _normal(rng, 2, 4, 21, 16), _normal(rng, 2, 2, 70, 16), _normal(rng, 2, 2, 70, 16)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=True, window=window, q_offset=49, impl="xla_flash")
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, window=window, q_offset=49)
    assert _diff(want, got) < F32_TOL
    plan = plan_lib.plan_attention((2, 4, 2, 21, 70, 16), phase=plan_lib.EXTEND,
                                   device_type="cpu", dtype_bytes=4)
    assert plan.impl == "plain" and plan.phase == plan_lib.EXTEND


def test_dense_extend_has_no_gradient_yet():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 2, 20, 16), torch.randn(1, 2, 20, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(q, k, v, q_offset=12)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, q_offset=12).shape == q.shape
    ops.flash_attention(q, k, v).sum().backward()       # offset 0 keeps its gradient
    assert q.grad is not None


# -- the paged extend's two routes ---------------------------------------------------


def _extend_inputs(rng, hq, hkv, *, d=16, ps=8, st=20, mp=5, num_pages=24):
    """Three rows: prefixes of 33 (not a page multiple), 0 and a full
    table; tails of 20 (full), 7 and 1 in a 20-row bucket."""
    b = 3
    pages = _normal(rng, 2, hkv, num_pages, ps, d)
    table = np.stack([rng.permutation(np.arange(1, num_pages))[:mp] for _ in range(b)])
    return dict(q=_normal(rng, b, hq, st, d), pages=pages, table=table.astype(np.int32),
                kt=_normal(rng, b, hkv, st, d), vt=_normal(rng, b, hkv, st, d),
                plen=np.array([33, 0, mp * ps], np.int32), tlen=np.array([st, 7, 1], np.int32))


@pytest.mark.parametrize("kv_dtype,hq,hkv,window", [
    ("fp32", 4, 2, None), ("fp32", 4, 1, 12), ("int8", 4, 4, None), ("int8", 4, 2, 12),
    ("fp8", 4, 1, None), ("fp8", 4, 4, 12)])
def test_gather_route_and_k2_match_jax_ref(kv_dtype, hq, hkv, window):
    """The gather route (``impl="gather"``: gather, pack, K1 with offsets)
    and K2's plain path, each against ``ref.paged_prefill_attention`` over
    the same pool (float32, or int8 / fp8 codes quantized by each package
    from the same values), to 2e-5; rows past tail_len exactly zero."""
    x = _extend_inputs(np.random.default_rng(hq + 10 * hkv), hq, hkv)
    jscales, tscales = {}, {}
    if kv_dtype == "fp32":
        jk, jv = jnp.asarray(x["pages"][0]), jnp.asarray(x["pages"][1])
        tk, tv = torch.from_numpy(x["pages"][0]), torch.from_numpy(x["pages"][1])
    else:
        (jk, jks), (jv, jvs) = (jax_quant.quantize_pages(jnp.asarray(p), kv_dtype)
                                for p in x["pages"])
        (tk, tks), (tv, tvs) = (quant.quantize_pages(torch.from_numpy(p), kv_dtype)
                                for p in x["pages"])
        jscales, tscales = dict(k_scales=jks, v_scales=jvs), dict(k_scales=tks, v_scales=tvs)
    want = jax_ref.paged_prefill_attention(
        jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["table"]), jnp.asarray(x["kt"]),
        jnp.asarray(x["vt"]), jnp.asarray(x["plen"]), jnp.asarray(x["tlen"]), window=window,
        **jscales)
    args = (torch.from_numpy(x["q"]), tk, tv, torch.from_numpy(x["table"]),
            torch.from_numpy(x["kt"]), torch.from_numpy(x["vt"]),
            torch.from_numpy(x["plen"]), torch.from_numpy(x["tlen"]))
    b, _, st, d = x["q"].shape
    shape = (b, hq, hkv, st, x["table"].shape[1] * 8 + st, d)
    for impl in (plan_lib.GATHER, "plain"):
        plan = plan_lib.plan_attention(shape, phase=plan_lib.EXTEND, kv_layout=plan_lib.PAGED,
                                       page_size=8, prefix_pages=x["table"].shape[1],
                                       device_type="cpu", dtype_bytes=4, impl=impl)
        assert plan.impl == impl
        got = ops.paged_prefill_attention(*args, window=window, plan=plan, **tscales)
        assert _diff(want, got) < F32_TOL, impl
        for i, t in enumerate(x["tlen"]):
            assert not got[i, :, t:].any()


def test_gather_stripes_pack_the_live_prefix_then_the_tail():
    x = _extend_inputs(np.random.default_rng(1), 4, 2)
    k, v = pp.gather_stripes(*(torch.from_numpy(a) for a in (
        x["pages"][0], x["pages"][1], x["table"], x["kt"], x["vt"], x["plen"])))
    assert k.shape == v.shape == (3, 2, 5 * 8 + 20, 16)
    for i, plen in enumerate(x["plen"]):
        dense = x["pages"][0][:, x["table"][i]].reshape(2, -1, 16)
        assert np.array_equal(k[i, :, :plen].numpy(), dense[:, :plen])
        assert np.array_equal(k[i, :, plen:plen + 20].numpy(), x["kt"][i])


# -- the extend-route scorer --------------------------------------------------------

#: The JAX presets the scorer runs on, as the port's Topology (no fitted
#: extend terms: the JAX formula), by the JAX plan's backend name.
JAX_TOPOS = {"gpu": jax_numa.MI300X, "tpu": jax_numa.TPU_V5P_MEGACORE}


def _port(t):
    return numa.Topology(**{f.name: getattr(t, f.name)
                            for f in dataclasses.fields(jax_numa.Topology)})


@pytest.mark.parametrize("backend", ["gpu", "tpu"])
def test_extend_route_scorer_matches_jax_on_its_presets(backend):
    """On a grid of shapes (the two of the JAX suite's route test among
    them), the ported scorer picks the JAX plan's route and both routes'
    estimates match to 1e-12."""
    topo = _port(JAX_TOPOS[backend])
    routes = {"pallas": "paged", "xla": plan_lib.GATHER}
    picked = set()
    shapes = [(1, 8, 1, 512, 16, 16, 64), (8, 32, 8, 64, 2048, 16, 128)]
    shapes += [(b, hq, hkv, tail, prefix, ps, d)
               for b in (1, 2, 8) for hq, hkv in ((32, 8), (8, 1), (25, 5))
               for tail, prefix in ((16, 256), (256, 1024), (512, 4096), (64, 16))
               for ps, d in ((16, 128), (8, 64))]
    for b, hq, hkv, tail, prefix, ps, d in shapes:
        for dtype_bytes in (1, 2):
            args = (b, hq, hkv, tail, prefix, ps, d, dtype_bytes)
            want = routes[jax_plan._score_extend_route(*args, backend)]
            assert plan_lib._score_extend_route(*args, topo=topo) == want, args
            picked.add(want)
            kw = dict(batch=b, num_q_heads=hq, num_kv_heads=hkv, prefix_len=prefix,
                      tail_len=tail, page_size=ps, head_dim=d, dtype_bytes=dtype_bytes)
            for gather in (False, True):
                mine = perf_model.estimate_extend_prefill(topo=topo, gather=gather, **kw)
                theirs = jax_pm.estimate_extend_prefill(topo=JAX_TOPOS[backend],
                                                        gather=gather, **kw)
                assert mine.time == pytest.approx(theirs.time, rel=REL, abs=0.0)
    assert picked == {"paged", plan_lib.GATHER}        # each route wins somewhere


def test_plan_scores_the_route_only_for_auto_with_prefix_pages(monkeypatch):
    """The JAX suite's two route shapes through ``plan_attention`` on the
    MI300X preset: gather at one MQA request, K2 at a batched GQA one; a
    pinned impl is never re-routed; no prefix pages, no scoring; "gather"
    pinned elsewhere raises, and a config's "gather" reaches only the paged
    extend."""
    monkeypatch.setattr(plan_lib, "TOPOLOGY", _port(jax_numa.MI300X))
    plan_lib._plan_cached.cache_clear()
    plan_lib._score_extend_route.cache_clear()
    kw = dict(phase=plan_lib.EXTEND, kv_layout=plan_lib.PAGED, page_size=16,
              device_type="cuda")
    gather_shape = (1, 8, 1, 512, 512 + 16, 64)
    assert plan_lib.plan_attention(gather_shape, prefix_pages=1, **kw).impl == plan_lib.GATHER
    assert plan_lib.plan_attention(gather_shape, prefix_pages=0, **kw).impl == "cuda"
    assert plan_lib.plan_attention(gather_shape, prefix_pages=1, impl="cuda", **kw).impl == "cuda"
    assert plan_lib.plan_attention((8, 32, 8, 64, 2048 + 64, 128), prefix_pages=128,
                                   **kw).impl == "cuda"
    plan_lib._plan_cached.cache_clear()
    plan_lib._score_extend_route.cache_clear()
    with pytest.raises(ValueError, match="gather"):
        plan_lib.plan_attention(gather_shape, phase=plan_lib.PREFILL, device_type="cuda",
                                impl=plan_lib.GATHER)
    with pytest.raises(ValueError, match="gather"):
        plan_lib.plan_attention((1, 8, 1, 1, 512, 64), phase=plan_lib.DECODE,
                                kv_layout=plan_lib.PAGED, page_size=16, device_type="cuda",
                                impl=plan_lib.GATHER)
    cfg = dataclasses.replace(llama3_8b.SMOKE, attn_impl=plan_lib.GATHER)
    assert plan_lib.plan_for_config(cfg, gather_shape, prefix_pages=1, **kw).impl == \
        plan_lib.GATHER
    assert plan_lib.plan_for_config(cfg, (1, 8, 1, 64, 64, 64), device_type="cpu",
                                    phase=plan_lib.PREFILL).impl == "plain"


#: plan part (d)'s shapes (tools/prefill_ab.py EXTEND_SHAPES): (rows,
#: prefix, tail) at llama3-8b widths.
CARD_SHAPES = ((1, 256, 16), (1, 1024, 256), (1, 4096, 64), (1, 2048, 512), (8, 256, 256),
               (8, 1024, 16), (8, 2048, 128), (8, 4096, 512), (8, 1024, 256), (1, 512, 128),
               (4, 4096, 256))


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_fitted_scorer_keeps_k2_where_the_card_measured_it_faster(kv_dtype):
    """On the H100 both routes run the same blocks and the gather adds its
    copies: the card measured K2 faster at every plan-(d) shape (PERF.md,
    PR 26), and the fitted scorer keeps K2 there, over a bf16 and an int8
    pool. The JAX formula on the same card (B x Hkv cells for K2) routes
    the one-row shapes to gather."""
    jax_formula = []
    for b, prefix, tail in CARD_SHAPES:
        mp = -(-prefix // 16)
        shape = (b, 32, 8, tail, mp * 16 + tail, 128)
        plan = plan_lib.plan_attention(shape, phase=plan_lib.EXTEND, kv_layout=plan_lib.PAGED,
                                       page_size=16, prefix_pages=mp, device_type="cuda",
                                       kv_dtype=kv_dtype)
        assert plan.impl == "cuda", (b, prefix, tail)
        jax_formula.append(plan_lib._score_extend_route(
            b, 32, 8, tail, mp * 16, 16, 128, 2,
            topo=dataclasses.replace(numa.H100, extend=None)))
    assert jax_formula[:4] == [plan_lib.GATHER] * 4


def test_fitted_extend_terms_price_the_port_kernels():
    """The H100's fitted terms: blocks and operations as K1 / K2 walk them
    (B x Hq x tail tiles of 128 rows, padded), the gather route dearer than
    K2 by at least its copy where K1 runs at K2's rate."""
    x = numa.H100.extend
    assert x is not None and x.tile_rows == 128
    blocks, flops = perf_model.extend_blocks(batch=2, num_q_heads=32, prefix_len=1000,
                                             tail_len=256, head_dim=128, tile_rows=128)
    assert blocks == 2 * 32 * 2
    assert flops == 4.0 * blocks * 128 * 128 * (8 + 1.5) * 128
    kw = dict(batch=8, num_q_heads=32, num_kv_heads=8, prefix_len=1024, tail_len=256,
              page_size=16, head_dim=128, dtype_bytes=2)
    equal = dataclasses.replace(numa.H100, extend=dataclasses.replace(
        x, gather_cell_flops=x.paged_cell_flops, gather_s=x.paged_launch_s))
    paged = perf_model.estimate_extend_prefill(topo=equal, **kw)
    gather = perf_model.estimate_extend_prefill(topo=equal, gather=True, **kw)
    prefix_bytes = 8 * 8 * 64 * 2.0 * 16 * 128 * 2
    assert gather.time == pytest.approx(paged.time + 2 * prefix_bytes / x.gather_bw, rel=1e-12)
    # The other fields stay the JAX formula's.
    jax_kw = dict(kw, topo=dataclasses.replace(numa.H100, extend=None))
    assert perf_model.estimate_extend_prefill(**jax_kw).hbm_bytes == paged.hbm_bytes


# -- the route through a paged engine ---------------------------------------------------


def test_engine_with_the_gather_route_pinned_matches_k2(monkeypatch):
    """llama3-8b SMOKE (the JAX package's weights), prompts sharing a
    32-token prefix: a paged engine whose config pins the gather route gives
    the greedy ids of one on K2's route (which ``test_torch_engine.py``
    holds to the JAX engine), over a float32 and an int8 pool, and every
    extend ran the gather route."""
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                         llama3_8b.SMOKE, device="cpu")
    calls = []
    gather = ops.paged_prefill_gather
    monkeypatch.setattr(ops, "paged_prefill_gather",
                        lambda *a, **kw: calls.append(a[0].shape) or gather(*a, **kw))
    rng = np.random.default_rng(8)
    head = rng.integers(1, llama3_8b.SMOKE.vocab, size=32)
    prompts = [np.concatenate([head, rng.integers(1, llama3_8b.SMOKE.vocab, size=n)])
               for n in (3, 11, 20)]
    gather_cfg = dataclasses.replace(llama3_8b.SMOKE, attn_impl=plan_lib.GATHER)
    for kv_dtype in ("fp32", "int8"):
        kw = dict(kv_layout="paged", num_pages=48, page_size=16, max_batch=3,
                  max_pages_per_seq=6, prompt_buckets=(16, 32, 64), device="cpu",
                  kv_dtype=kv_dtype)
        ids, extends = [], []
        for cfg in (llama3_8b.SMOKE, gather_cfg):
            calls.clear()
            eng = LLMEngine(cfg, params, **kw)
            ids.append({o.uid: [int(t) for t in o.tokens] for o in eng.generate(
                [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])})
            extends.append(eng.backend.stats["extend_prefills"])
            eng.close()
        assert ids[1] == ids[0]
        assert extends[1] >= 2
        layers = llama3_8b.SMOKE.n_layers
        assert len(calls) >= layers and len(calls) % layers == 0
