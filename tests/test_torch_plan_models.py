"""The plan's models in the PyTorch port against the JAX package: the NUMA
descriptors, the swizzle arithmetic, ACCs, the cache simulator, the
analytic estimates (mapping, extend prefill, host tier, split-K at the
JAX package's terms), the Hopper byte count of K1 and the mapping scorer.

Topologies are built from the JAX presets' own fields and from made-up
ones; integer results must be equal and floats agree to 1e-12 relative."""

import dataclasses
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import acc as jax_acc
from repro.core import cache_sim as jax_sim
from repro.core import numa as jax_numa
from repro.core import perf_model as jax_pm
from repro.core import swizzle as jax_swizzle

from repro_torch.core import acc, cache_sim, numa, perf_model, swizzle
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import plan as plan_lib

REL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Under pytest-xdist, intra-op threads contend with the other workers'
    and a CPU matmul may then split its sums another way: two calls of
    the same plain attention gave different bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: Made-up machines beside the JAX presets: odd domain counts, tiny caches.
MADE_UP = (
    jax_numa.Topology(name="odd3", num_domains=3, slots_per_domain=5,
                      cache_bytes=96 * 1024, peak_flops=2.0e14, hbm_bw=1.1e12, link_bw=7e10),
    jax_numa.Topology(name="wide16", num_domains=16, slots_per_domain=4,
                      cache_bytes=2 * 1024 * 1024, peak_flops=8.0e14, hbm_bw=4.0e12,
                      link_bw=2e11),
)
JAX_TOPOS = (jax_numa.MI300X, jax_numa.TPU_V5P_MEGACORE) + MADE_UP


def port_topo(t):
    """The port's Topology from a JAX one's fields (split terms at their
    defaults: the JAX package's formula)."""
    return numa.Topology(**{f.name: getattr(t, f.name) for f in dataclasses.fields(t)})


def jax_topo(t):
    """A JAX Topology from the port's first seven fields."""
    return jax_numa.Topology(**{f.name: getattr(t, f.name)
                                for f in dataclasses.fields(jax_numa.Topology)})


def close(a, b):
    return a == b or math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def fields_close(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    for key, value in db.items():
        if isinstance(value, float):
            assert close(da[key], value), (key, da[key], value)
        else:
            assert da[key] == value, (key, da[key], value)


def grids(draw_batch=st.integers(1, 3)):
    return st.tuples(draw_batch, st.sampled_from([(4, 1), (8, 2), (8, 8), (12, 3), (6, 6)]),
                     st.integers(1, 9))


def test_presets_and_properties_match():
    mine = port_topo(jax_numa.MI300X)
    assert mine == dataclasses.replace(numa.MI300X)
    for t in JAX_TOPOS:
        p = port_topo(t)
        assert (p.total_slots, p.flops_per_slot, p.hbm_bw_per_slot) == \
            (t.total_slots, t.flops_per_slot, t.hbm_bw_per_slot)
    assert swizzle.ALL_MAPPINGS == jax_swizzle.ALL_MAPPINGS
    assert swizzle.TRAVERSALS == jax_swizzle.TRAVERSALS


@settings(max_examples=40, deadline=None)
@given(grids(), st.sampled_from([1, 2, 3, 4, 8]))
def test_swizzle_decode_encode_identical(g, domains):
    b, (hq, group), blocks = g
    grid = swizzle.AttentionGrid(batch=b, num_q_heads=hq, blocks_per_head=blocks,
                                 group_size=group)
    jgrid = jax_swizzle.AttentionGrid(batch=b, num_q_heads=hq, blocks_per_head=blocks,
                                      group_size=group)
    assert (grid.num_kv_heads, grid.wgs_per_batch, grid.total_wgs, grid.num_accs) == \
        (jgrid.num_kv_heads, jgrid.wgs_per_batch, jgrid.total_wgs, jgrid.num_accs)
    wids = np.arange(grid.total_wgs)
    assert np.array_equal(swizzle.domain_of(wids, domains), jax_swizzle.domain_of(wids, domains))
    for m in swizzle.ALL_MAPPINGS:
        mine = swizzle.decode(m, wids, grid, domains)
        theirs = jax_swizzle.decode(m, wids, jgrid, domains)
        for x, y in zip(mine, theirs):
            assert np.array_equal(x, y), m
        assert np.array_equal(swizzle.encode(m, *mine, grid, domains),
                              jax_swizzle.encode(m, *theirs, jgrid, domains))
        assert swizzle.heads_per_domain_sets(m, grid, domains) == \
            jax_swizzle.heads_per_domain_sets(m, jgrid, domains)
        for window in (1, 3, 38):
            assert swizzle.accs_per_domain_concurrent(m, grid, domains, window) == \
                jax_swizzle.accs_per_domain_concurrent(m, jgrid, domains, window)
    with pytest.raises(ValueError):
        swizzle.decode("diagonal", wids, grid, domains)


@settings(max_examples=30, deadline=None)
@given(grids(), st.integers(1, 70000), st.sampled_from([64, 128]), st.sampled_from([64, 128]),
       st.sampled_from([1, 2, 4]), st.sampled_from([1, 2, 8]))
def test_acc_identical(g, seq, d, bm, dtype_bytes, domains):
    b, (hq, group), blocks = g
    grid = swizzle.AttentionGrid(batch=b, num_q_heads=hq, blocks_per_head=blocks,
                                 group_size=group)
    jgrid = jax_swizzle.AttentionGrid(batch=b, num_q_heads=hq, blocks_per_head=blocks,
                                      group_size=group)
    mine = acc.acc_info(grid, seq_len_kv=seq, head_dim=d, block_m=bm, dtype_bytes=dtype_bytes)
    theirs = jax_acc.acc_info(jgrid, seq_len_kv=seq, head_dim=d, block_m=bm,
                              dtype_bytes=dtype_bytes)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.fits_cache(4 << 20) == theirs.fits_cache(4 << 20)
    assert acc.accs_per_domain(grid, domains) == jax_acc.accs_per_domain(jgrid, domains)
    heads = np.arange(hq)
    assert np.array_equal(acc.acc_of(heads, group), jax_acc.acc_of(heads, group))


def _workloads(mod, *, h, g, n, b=1, d=128, bm=128, bn=64, causal=True, pass_="fwd"):
    return mod.AttentionWorkload(
        grid=(swizzle if mod is cache_sim else jax_swizzle).AttentionGrid(
            batch=b, num_q_heads=h, blocks_per_head=0, group_size=g),
        seq_len=n, head_dim=d, block_m=bm, block_n=bn, causal=causal, pass_=pass_)


SIM_CASES = [
    dict(h=16, g=1, n=2048),
    dict(h=8, g=4, n=1536, b=2, bn=128),
    dict(h=12, g=3, n=1000, causal=False, d=64),
    dict(h=8, g=2, n=1024, pass_="bwd"),
]


@pytest.mark.parametrize("case", range(len(SIM_CASES)))
@pytest.mark.parametrize("topo", [jax_numa.MI300X, MADE_UP[0]], ids=lambda t: t.name)
def test_cache_sim_identical(case, topo):
    kw = SIM_CASES[case]
    mine_wl, their_wl = _workloads(cache_sim, **kw), _workloads(jax_sim, **kw)
    assert cache_sim.default_max_wgs(mine_wl, 200_000) == \
        jax_sim.default_max_wgs(their_wl, 200_000)
    mine = cache_sim.compare_mappings(mine_wl, port_topo(topo), budget_accesses=60_000)
    theirs = jax_sim.compare_mappings(their_wl, topo, budget_accesses=60_000)
    assert mine.keys() == theirs.keys()
    for m in mine:
        a, b = mine[m], theirs[m]
        assert (a.hits, a.misses, a.hbm_bytes, a.simulated_wgs, a.total_wgs, a.per_tensor) == \
            (b.hits, b.misses, b.hbm_bytes, b.simulated_wgs, b.total_wgs, b.per_tensor), m
        for key in ("elapsed", "compute_time", "hbm_time", "total_flops", "hit_rate"):
            assert close(getattr(a, key), getattr(b, key)), (m, key)
        assert a.bound == b.bound
    one = cache_sim.simulate(swizzle.NAIVE_HEAD_FIRST, mine_wl, port_topo(topo), max_wgs=64,
                             domain=topo.num_domains - 1)
    two = jax_sim.simulate(swizzle.NAIVE_HEAD_FIRST, their_wl, topo, max_wgs=64,
                           domain=topo.num_domains - 1)
    assert (one.hits, one.misses, one.hbm_bytes) == (two.hits, two.misses, two.hbm_bytes)


@pytest.mark.parametrize("policy", ["head_aligned", "interleaved"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_paged_decode_identical(policy, seed):
    rng = np.random.default_rng(seed)
    b, width, hkv = 5, 9, 4
    tables = rng.permutation(1 + b * width)[: b * width].reshape(b, width)
    tables[1, :4] = tables[0, :4]                      # a shared prefix
    lengths = rng.integers(0, width * 16 + 1, size=b)
    for t in JAX_TOPOS:
        t = dataclasses.replace(t, cache_bytes=int(t.cache_bytes) % (1 << 20) + 40_000)
        kw = dict(num_kv_heads=hkv, page_size=16, head_dim=64, policy=policy, group_size=2)
        mine = cache_sim.simulate_paged_decode(tables, lengths, topo=port_topo(t), **kw)
        theirs = jax_sim.simulate_paged_decode(tables, lengths, topo=t, **kw)
        fields_close(mine, theirs)


@pytest.mark.parametrize("seed", [0, 1])
def test_simulate_tiered_decode_identical(seed, monkeypatch):
    monkeypatch.setattr(perf_model, "HOST_LINK_BW", jax_pm.HOST_LINK_BW)
    rng = np.random.default_rng(seed)
    trace = [(int(h), int(p)) for h, p in rng.integers(0, [3, 40], size=(400, 2))]
    for device_pages, host_pages in ((8, 0), (16, 24), (40, 100)):
        kw = dict(page_bytes=4096, device_pages=device_pages, host_pages=host_pages,
                  recompute_s_per_page=3e-5)
        mine = cache_sim.simulate_tiered_decode(trace, topo=port_topo(jax_numa.MI300X), **kw)
        theirs = jax_sim.simulate_tiered_decode(trace, topo=jax_numa.MI300X, **kw)
        fields_close(mine, theirs)
        assert mine.rescue_rate == theirs.rescue_rate


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4), st.sampled_from([(32, 8), (16, 16), (25, 5), (8, 1)]),
       st.integers(16, 20000), st.sampled_from([64, 128]), st.sampled_from([(128, 64),
                                                                            (128, 128), (64, 64)]),
       st.booleans(), st.sampled_from([1, 2, 4]), st.sampled_from(range(len(JAX_TOPOS))))
def test_estimate_identical(b, heads, seq, d, blocks, causal, dtype_bytes, ti):
    hq, hkv = heads
    bm, bn = blocks
    t = JAX_TOPOS[ti]
    kw = dict(seq_len=seq, head_dim=d, block_m=bm, block_n=bn, causal=causal,
              dtype_bytes=dtype_bytes)
    mine_wl = cache_sim.AttentionWorkload(
        grid=swizzle.AttentionGrid(batch=b, num_q_heads=hq, blocks_per_head=-(-seq // bm),
                                   group_size=hq // hkv), **kw)
    their_wl = jax_sim.AttentionWorkload(
        grid=jax_swizzle.AttentionGrid(batch=b, num_q_heads=hq, blocks_per_head=-(-seq // bm),
                                       group_size=hq // hkv), **kw)
    assert close(perf_model._mean_kv_tiles(mine_wl), jax_pm._mean_kv_tiles(their_wl))
    for m in swizzle.ALL_MAPPINGS:
        mine = perf_model.estimate(m, mine_wl, port_topo(t))
        theirs = jax_pm.estimate(m, their_wl, t)
        fields_close(mine, theirs)
        assert close(mine.throughput, theirs.throughput)
    rel = perf_model.relative_performance(mine_wl, port_topo(t))
    jrel = jax_pm.relative_performance(their_wl, t)
    assert rel.keys() == jrel.keys() and all(close(rel[k], jrel[k]) for k in rel)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 8), st.sampled_from([(32, 8), (8, 8), (25, 5), (16, 1)]),
       st.integers(0, 9000), st.integers(1, 3000), st.sampled_from([8, 16, 64]),
       st.sampled_from([64, 128]), st.sampled_from([1, 2, 4]), st.booleans(),
       st.sampled_from(range(len(JAX_TOPOS))))
def test_extend_prefill_identical(b, heads, prefix, tail, ps, d, dtype_bytes, gather, ti):
    hq, hkv = heads
    t = JAX_TOPOS[ti]
    kw = dict(batch=b, num_q_heads=hq, num_kv_heads=hkv, prefix_len=prefix, tail_len=tail,
              page_size=ps, head_dim=d, dtype_bytes=dtype_bytes, gather=gather)
    mine = perf_model.estimate_extend_prefill(topo=port_topo(t), **kw)
    theirs = jax_pm.estimate_extend_prefill(topo=t, policy="head_aligned", **kw)
    assert mine.layout == theirs.layout
    for key in ("time", "hbm_bytes", "link_bytes", "flops", "reuse_rate"):
        assert close(getattr(mine, key), getattr(theirs, key)), key
    with pytest.raises(ValueError):
        perf_model.estimate_extend_prefill(topo=port_topo(t), policy="interleaved", **kw)


def test_tier_transfer_identical_at_jax_constants(monkeypatch):
    monkeypatch.setattr(perf_model, "HOST_LINK_BW", jax_pm.HOST_LINK_BW)
    monkeypatch.setattr(perf_model, "TIER_TRANSFER_FIXED_S", jax_pm.HOST_SYNC_OVERHEAD_S)
    for nbytes in (-5, 0, 1, 4096, 2 << 20, 3 << 30):
        assert close(perf_model.estimate_tier_transfer(nbytes),
                     jax_pm.estimate_tier_transfer(nbytes))
        for recompute in (-1.0, 0.0, 1e-5, 1e-3, 2.0):
            assert perf_model.tier_transfer_beats_recompute(nbytes, recompute) == \
                jax_pm.tier_transfer_beats_recompute(nbytes, recompute)


def test_tier_transfer_at_the_card_constants():
    """The measured link: positive, linear in bytes past the fixed cost."""
    one = perf_model.estimate_tier_transfer(2 << 20)
    eight = perf_model.estimate_tier_transfer(8 * (2 << 20))
    assert one > 0 and close(eight - one, 7 * (2 << 20) / perf_model.HOST_LINK_BW)
    assert perf_model.HOST_LINK_BW != jax_pm.HOST_LINK_BW


@settings(max_examples=80, deadline=None)
@given(st.integers(1, 16), st.sampled_from([(32, 8), (8, 8), (25, 5), (16, 1), (9, 3)]),
       st.integers(1, 9000), st.sampled_from([8, 16, 64, 128]), st.sampled_from([64, 128]),
       st.sampled_from([1, 2, 4]), st.sampled_from([None, 0, 512, 4096]),
       st.sampled_from(range(len(JAX_TOPOS))), st.integers(1, 20))
def test_decode_splits_identical_at_default_terms(b, heads, seq, granule, d, dtype_bytes,
                                                  window, ti, max_splits):
    hq, hkv = heads
    t = JAX_TOPOS[ti]
    kw = dict(batch=b, num_q_heads=hq, num_kv_heads=hkv, seq_kv=seq, granule=granule,
              head_dim=d, dtype_bytes=dtype_bytes, window=window, max_splits=max_splits)
    saved = perf_model.COMBINE_LAUNCH_OVERHEAD_S
    perf_model.COMBINE_LAUNCH_OVERHEAD_S = jax_pm.COMBINE_LAUNCH_OVERHEAD_S
    try:
        mine = perf_model.estimate_decode_splits(topo=port_topo(t), **kw)
    finally:
        perf_model.COMBINE_LAUNCH_OVERHEAD_S = saved
    theirs = jax_pm.estimate_decode_splits(topo=t, **kw)
    assert mine.num_splits == theirs.num_splits
    assert [s for s, _ in mine.times] == [s for s, _ in theirs.times]
    assert all(close(a, b) for (_, a), (_, b) in zip(mine.times, theirs.times))
    assert close(mine.time, theirs.time) and close(mine.base_time, theirs.base_time)
    assert close(mine.speedup, theirs.speedup)


def _brute_tiles(seq, bm, bn, causal, window):
    """KV tiles each q block of a square launch walks, from the masks: a
    tile is walked when one of its keys is live for one of the block's
    rows."""
    rows = 0
    for q0 in range(0, seq, bm):
        r = np.arange(q0, min(q0 + bm, seq))[:, None]
        k = np.arange(seq)[None, :]
        live = np.ones((len(r), seq), bool)
        if causal:
            live &= k <= r
        if window:
            live &= k > r - window
        tiles = np.unique(np.nonzero(live.any(0))[0] // bn)
        rows += sum(min(bn, seq - n * bn) for n in tiles)
    return rows


@pytest.mark.parametrize("seq", [1, 100, 128, 129, 1000, 2048])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 300), (False, None)])
@pytest.mark.parametrize("d", [64, 256])
def test_hbm_block_fetches_counts_the_tiles_k1_walks(seq, dtype_bytes, causal, window, d):
    bm, bn = fa.tiles(dtype_bytes, d)
    assert (bm, bn) == ((128, 64 if d == 256 else 128) if dtype_bytes == 2 else (64, 64))
    counts = [fa.hbm_block_fetches(batch=2, num_q_heads=8, num_kv_heads=2, seq_q=seq,
                                   seq_kv=seq, head_dim=d, dtype_bytes=dtype_bytes,
                                   mapping=m, causal=causal, window=window)
              for m in plan_lib.CANDIDATES]
    assert all(c == counts[0] for c in counts)       # a TMA pipeline skips no copy
    row = d * dtype_bytes
    assert counts[0]["q_bytes"] == 2 * 8 * seq * row
    assert counts[0]["kv_bytes"] == 2 * 2 * 8 * _brute_tiles(seq, bm, bn, causal, window) * row
    assert counts[0]["ideal_bytes"] == 2 * (2 * 2 * seq + 8 * seq) * row


def _brute_pick(b, hq, hkv, sq, skv, d, dtype_bytes, decode, window):
    """The scorer's argmin written out: each candidate priced by the JAX
    package's ``perf_model.estimate`` on the port's cache view, then the
    Hopper byte count, then its rank."""
    causal = not decode
    if window:
        skv = min(skv, -(-(window + (0 if decode else sq)) // 128) * 128)
    bm, bn = fa.tiles(dtype_bytes, d)
    wl = jax_sim.AttentionWorkload(
        grid=jax_swizzle.AttentionGrid(batch=b, num_q_heads=hq, blocks_per_head=-(-skv // bm),
                                       group_size=hq // hkv),
        seq_len=skv, head_dim=d, block_m=bm, block_n=bn, causal=causal,
        dtype_bytes=dtype_bytes)
    topo = jax_topo(plan_lib.CACHE_TOPOLOGY)
    keys = []
    for rank, m in enumerate(plan_lib.CANDIDATES):
        name = {fa.HEAD_FIRST: "naive_head_first", fa.BLOCK_FIRST: "naive_block_first"}[m.order]
        traffic = fa.hbm_block_fetches(batch=b, num_q_heads=hq, num_kv_heads=hkv, seq_q=sq,
                                       seq_kv=skv, head_dim=d, dtype_bytes=dtype_bytes,
                                       mapping=m, causal=causal, window=window)
        keys.append((jax_pm.estimate(name, wl, topo).time, traffic["total_bytes"], rank))
    return plan_lib.CANDIDATES[min(keys)[2]]


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4), st.sampled_from([(32, 8), (25, 5), (8, 8), (16, 2)]),
       st.integers(1, 9000), st.sampled_from([64, 128, 256]), st.sampled_from([2, 4]),
       st.booleans(), st.sampled_from([None, 256, 1024]))
def test_score_mapping_is_the_brute_force_argmin(b, heads, seq, d, dtype_bytes, decode,
                                                 window):
    hq, hkv = heads
    sq = 1 if decode else seq
    picked = plan_lib._score_mapping(b, hq, hkv, sq, seq, d, dtype_bytes, decode, window)
    assert picked in plan_lib.CANDIDATES
    assert picked == _brute_pick(b, hq, hkv, sq, seq, d, dtype_bytes, decode, window)
    phase = plan_lib.DECODE if decode else plan_lib.PREFILL
    kw = dict(kv_layout=plan_lib.DENSE, phase=phase, dtype_bytes=dtype_bytes, window=window,
              device_type="cpu")
    assert plan_lib.plan_attention((b, hq, hkv, sq, seq, d), **kw).mapping == picked


@pytest.mark.parametrize("b,s", [(1, 512), (2, 2048), (1, 4096), (1, 8192), (4, 4096)])
def test_card_pick_is_head_first_linear_at_llama_prefill(b, s):
    plan = plan_lib.plan_attention((b, 32, 8, s, s, 128), device_type="cuda")
    assert plan.mapping == fa.MappingConfig(order=fa.HEAD_FIRST, traversal=swizzle.LINEAR)


def test_pinned_and_extend_mappings():
    shape = (2, 32, 8, 256, 256, 128)
    for name, m in fa.PAPER_MAPPINGS.items():
        assert plan_lib.plan_attention(shape, mapping_name=name, device_type="cpu").mapping == m
    with pytest.raises(KeyError):
        plan_lib.plan_attention(shape, mapping_name="diagonal", device_type="cpu")
    ext = plan_lib.plan_attention((2, 32, 8, 64, 320, 128), phase=plan_lib.EXTEND,
                                  kv_layout=plan_lib.PAGED, page_size=16, device_type="cpu")
    assert ext.mapping == fa.MappingConfig()


@pytest.mark.parametrize("phase", ["prefill", "decode", "extend"])
def test_estimate_attention_plan_dispatch(phase):
    shape = (2, 32, 8, 1 if phase == "decode" else 64, 320, 128)
    kv = plan_lib.DENSE if phase == "prefill" else plan_lib.PAGED
    plan = plan_lib.plan_attention(shape, phase=phase, kv_layout=kv,
                                   page_size=16 if kv == plan_lib.PAGED else None,
                                   device_type="cpu")
    est = perf_model.estimate_attention_plan(plan, shape, topo=plan_lib.CACHE_TOPOLOGY)
    if phase == "prefill":
        assert est.mapping == "naive_head_first" and est.time > 0
    elif phase == "decode":
        assert est.layout == "paged:head_aligned"
    else:
        assert est.layout == "extend:paged"


def test_every_pick_computes_the_same_attention():
    """Mappings change no output: K1's CPU route and the plain version
    under each candidate the scorer may return."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4, 40, 64), generator=gen) for _ in range(3))
    k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
    outs = [fa.flash_attention_fwd(q, k, v, mapping=m, causal=True)
            for m in plan_lib.CANDIDATES]
    for o, lse in outs[1:]:
        assert torch.equal(o, outs[0][0]) and torch.equal(lse, outs[0][1])
