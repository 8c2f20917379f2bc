"""The port's single-device surface against the JAX package: the prefix
cache's lookup counters through a paged engine, ``cache.layout``'s traffic
model (the page-placement A/B), the engines' plan introspection and
``Request.eos_id`` / ``temperature`` / ``clone()``."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.cache import layout as jax_layout
from repro.configs import llama3_8b as jax_llama
from repro.core import numa as jax_numa
from repro.models import transformer as jax_tf
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest

from repro_torch import cache as cache_pkg
from repro_torch.cache import layout
from repro_torch.configs import llama3_8b
from repro_torch.core import numa
from repro_torch.core.device import dtype_of
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.flash_attention import PAPER_MAPPINGS
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request, SamplingParams

CFG = llama3_8b.SMOKE
#: The smallest engine that showed the missing counters (ROADMAP Queue C).
PAGED_KW = dict(num_pages=96, page_size=16, max_batch=2, max_pages_per_seq=8,
                prompt_buckets=(16, 32))


@pytest.fixture(scope="module")
def models():
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams), CFG,
                                         device="cpu")
    return jparams, params


# -- the prefix cache's counters ------------------------------------------------

COUNTERS = ("prefix_lookup_hits", "prefix_lookup_queries", "prefix_evictions")


def test_prefix_counters_match_jax_through_hits_and_evictions(models):
    """One trace through both paged engines: a shared 32-token head read
    back by later prompts (hits), then enough distinct 32-token prompts to
    fill the pool with cached pages, so admission evicts. Both engines count
    the same lookups, hits and evicted entries, and the same pages."""
    jparams, params = models
    rng = np.random.default_rng(5)
    head = rng.integers(1, CFG.vocab, size=32)
    waves = [[head], [np.concatenate([head, rng.integers(1, CFG.vocab, size=n)])
                      for n in (7, 16)]]
    waves.append([rng.integers(1, CFG.vocab, size=32) for _ in range(47)])
    waves.append([head])
    jeng = JaxEngine(jax_llama.SMOKE, jparams, kv_layout="paged", **PAGED_KW)
    teng = LLMEngine(CFG, params, kv_layout="paged", device="cpu", **PAGED_KW)
    uid = 0
    for wave in waves:
        jreqs, treqs = [], []
        for p in wave:
            jreqs.append(JaxRequest(uid=uid, prompt=p, max_new_tokens=1))
            treqs.append(Request(uid=uid, prompt=p, max_new_tokens=1))
            uid += 1
        jout = {o.uid: [int(t) for t in o.tokens] for o in jeng.generate(jreqs)}
        tout = {o.uid: [int(t) for t in o.tokens] for o in teng.generate(treqs)}
        assert tout == jout
    jstats, tstats = jeng.backend.prefix_stats(), teng.backend.prefix_stats()
    assert {k: tstats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}
    assert tstats["prefix_lookup_hits"] >= 4
    assert tstats["prefix_evictions"] >= 1
    assert tstats["pages_reused"] == jstats["pages_reused"]
    pc = teng.backend.prefix.counters()
    assert pc == jeng.backend.prefix.counters()
    assert teng.backend.prefix.stats() == jeng.backend.prefix.stats()
    assert teng.backend.prefix.hit_rate == pytest.approx(jeng.backend.prefix.hit_rate)
    teng.close()


def test_peek_lookups_leave_the_counters_alone():
    pool = cache_pkg.PagePool(8, 4)
    cache = cache_pkg.PrefixCache(pool)
    hashes = cache_pkg.page_hashes(np.arange(12), 4)
    seq = pool.allocate_sequence(12)
    cache.insert(hashes[:2], seq.pages[:2])
    assert cache.lookup(hashes, touch=False) == seq.pages[:2]
    assert cache.counters() == {"entries": 2, "hits": 0, "queries": 0, "evictions": 0,
                                "hit_rate": 0.0}
    assert cache.lookup(hashes) == seq.pages[:2]
    assert (cache.hits, cache.queries, cache.hit_rate) == (2, 3, 2 / 3)
    pool.release(seq)
    assert cache.evict(1) == 1 and cache.evictions == 1
    assert cache.stats() == (1, 2, 3)


# -- cache.layout's traffic model -------------------------------------------------

MI300X = numa.Topology(**{f.name: getattr(jax_numa.MI300X, f.name)
                          for f in dataclasses.fields(jax_numa.Topology)})


def _tables(seed, batch, width, num_pages, shared):
    """Page tables of ``batch`` rows sharing their first ``shared`` pages,
    ragged live lengths (one row empty, one a single token)."""
    rng = np.random.default_rng(seed)
    head = rng.choice(np.arange(1, num_pages), size=shared, replace=False)
    rest = rng.choice(np.arange(1, num_pages), size=(batch, width - shared))
    tables = [list(head) + list(r) for r in rest]
    lengths = list(rng.integers(1, width * 16 + 1, size=batch))
    lengths[0], lengths[-1] = 0, 1
    return tables, lengths


@pytest.mark.parametrize("seed,batch,width,shared,ps,hkv,dtype_bytes", [
    (0, 4, 6, 0, 16, 8, 2),
    (1, 6, 9, 4, 16, 8, 2),
    (2, 3, 5, 5, 8, 1, 1),
    (3, 5, 12, 3, 32, 16, 4),
    (4, 7, 4, 2, 16, 3, 2),
])
def test_page_traffic_equals_jax(seed, batch, width, shared, ps, hkv, dtype_bytes):
    tables, lengths = _tables(seed, batch, width, 64, shared)
    kw = dict(num_kv_heads=hkv, page_size=ps, head_dim=64, dtype_bytes=dtype_bytes)
    mine = layout.compare_policies(tables, lengths, topo=MI300X, **kw)
    theirs = jax_layout.compare_policies(tables, lengths, topo=jax_numa.MI300X, **kw)
    assert tuple(mine) == tuple(theirs) == cache_pkg.PAGE_POLICIES
    for policy in cache_pkg.PAGE_POLICIES:
        a, b = mine[policy], theirs[policy]
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.local_fraction, a.reuse_rate) == (b.local_fraction, b.reuse_rate)
        assert a.time(MI300X) == b.time(jax_numa.MI300X)
        one = layout.decode_page_traffic(tables, lengths, topo=MI300X, policy=policy, **kw)
        assert one == a
    if shared and batch > 1:
        assert mine[layout.HEAD_ALIGNED].reuse_hits > 0
    assert mine[layout.HEAD_ALIGNED].remote_bytes == 0


def test_page_traffic_rejects_an_unknown_policy():
    with pytest.raises(ValueError):
        layout.decode_page_traffic([[1, 2]], [20], num_kv_heads=2, page_size=16,
                                   head_dim=64, topo=MI300X, policy="striped")


@pytest.mark.parametrize("num_units,num_splits", [
    (8, 2), (8, 7), (13, 4), (16, 16), (5, 2),             # tests/test_split_decode.py's
    (1, 1), (5, 4), (36, 2), (260, 9), (7, 16), (0, 4)])
@pytest.mark.parametrize("policy", ["head_aligned", "interleaved"])
def test_split_ranges_domain_aligned_equals_jax(num_units, num_splits, policy):
    ranges = layout.decode_split_ranges(num_units, num_splits)
    assert ranges == jax_layout.decode_split_ranges(num_units, num_splits)
    cells = [(h, hkv, 8) for hkv in (1, 2, 8) for h in range(hkv)] + [(3, 8, 1)]
    for head, hkv, domains in cells:
        kw = dict(head=head, policy=policy, num_kv_heads=hkv, num_domains=domains)
        mine = layout.split_ranges_domain_aligned(ranges, **kw)
        assert mine == jax_layout.split_ranges_domain_aligned(ranges, **kw)
        if policy == "head_aligned" or domains == 1:
            assert mine
        elif max(e - s for s, e in ranges) > 1:
            assert not mine


# -- introspection ---------------------------------------------------------------


def test_engine_plan_introspection(models):
    _, params = models
    itemsize = dtype_of(CFG.compute_dtype).itemsize
    dense = LLMEngine(CFG, params, kv_layout="dense", max_batch=2, cache_len=64,
                      prompt_buckets=(16,), device="cpu")
    assert dense.mapping is plan_lib.plan_for_config(
        CFG, (2, CFG.n_heads, CFG.n_kv_heads, 64, 64, CFG.head_dim), device_type="cpu",
        phase=plan_lib.PREFILL, dtype_bytes=itemsize).mapping
    pinned = LLMEngine(CFG, params, kv_layout="dense", max_batch=2, cache_len=64,
                       prompt_buckets=(16,), device="cpu", mapping="naive_block_first")
    assert pinned.mapping is PAPER_MAPPINGS["naive_block_first"]
    with pytest.raises(KeyError):
        LLMEngine(CFG, params, kv_layout="dense", max_batch=2, cache_len=64,
                  prompt_buckets=(16,), device="cpu", mapping="bogus")
    for kv_dtype in ("fp32", "int8"):
        paged = LLMEngine(CFG, params, kv_layout="paged", num_pages=32, page_size=16,
                          max_batch=2, max_pages_per_seq=4, prompt_buckets=(16, 32),
                          device="cpu", kv_dtype=kv_dtype)
        want = plan_lib.plan_for_config(
            CFG, (2, CFG.n_heads, CFG.n_kv_heads, 1, 64, CFG.head_dim), device_type="cpu",
            phase=plan_lib.DECODE, kv_layout=plan_lib.PAGED, page_size=16,
            dtype_bytes=itemsize, kv_dtype=kv_dtype)
        assert paged.backend.decode_plan() is want
        assert paged.mapping is want.mapping
        assert paged.backend.modeled_kv_layout() == plan_lib.resolve_kv_layout(
            (2, CFG.n_heads, CFG.n_kv_heads, 32, CFG.head_dim), capacity=64, page_size=16,
            dtype_bytes=1 if kv_dtype == "int8" else itemsize)
        paged.close()
    dense.close()
    pinned.close()


def test_request_legacy_fields_and_clone(models):
    _, params = models
    r = Request(3, np.arange(1, 6), eos_id=7, temperature=0.5, max_new_tokens=4)
    assert (r.eos_id, r.temperature, r.max_new_tokens) == (7, 0.5, 4)
    plain = Request(4, np.arange(3), SamplingParams(max_tokens=2))
    assert plain.eos_id is None and plain.temperature == 0.0
    c = r.clone()
    assert c is not r and c.prompt is not r.prompt
    assert (c.uid, c.sampling, c.priority) == (r.uid, r.sampling, r.priority)
    assert np.array_equal(c.prompt, r.prompt)
    # A request set reruns through clone() to the same greedy ids.
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(1, CFG.vocab, size=n), max_new_tokens=4, priority=i % 2)
            for i, n in enumerate((5, 20, 11))]
    eng = LLMEngine(CFG, params, kv_layout="paged", device="cpu", **PAGED_KW)
    runs = [{o.uid: list(o.tokens) for o in eng.generate([q.clone() for q in reqs])}
            for _ in range(2)]
    assert runs[0] == runs[1] and sorted(runs[0]) == [0, 1, 2]
    eng.close()
