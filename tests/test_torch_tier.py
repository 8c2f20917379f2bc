"""The port's host KV tier (``repro_torch.cache.tier`` and ``PagedBackend``'s
demote and promote hooks) on the CPU, held to ``tests/test_tiering.py``'s
bars: a tiered engine (a device pool too small for the workload, a host
tier behind it) gives the untiered engine's greedy ids bit for bit, and the
JAX engine's, through demote -> promote round trips and preemption ->
resume, with demotions and promotions counted, and closes leak-free.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jax_llama
from repro.models import transformer as jax_tf
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling

from repro_torch.cache.pool import PagePool
from repro_torch.cache.prefix import PrefixCache
from repro_torch.cache.tier import HostPageStore
from repro_torch.configs import llama3_8b
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request, SamplingParams
from repro_torch.serving.scheduler import SchedulerStats

CFG = llama3_8b.SMOKE


@pytest.fixture(scope="module")
def models():
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams), CFG,
                                         device="cpu")
    return jparams, params


def _greedy(engine, prompts, n_new, uid0=0):
    outs = engine.generate([Request(uid0 + i, p, SamplingParams(max_tokens=n_new))
                            for i, p in enumerate(prompts)])
    return {o.uid - uid0: [int(t) for t in o.tokens] for o in outs}


def _jax_greedy(jparams, prompts, n_new, **kw):
    eng = JaxEngine(jax_llama.SMOKE, jparams, kv_layout="paged", page_size=8, **kw)
    outs = eng.generate([JaxRequest(i, p, JaxSampling(max_tokens=n_new))
                         for i, p in enumerate(prompts)])
    eng.close()
    return {o.uid: [int(t) for t in o.tokens] for o in outs}


# -- the store -----------------------------------------------------------------


def test_host_store_lru_and_counters():
    store = HostPageStore(capacity_bytes=4 * 100, page_nbytes=100)
    assert store.capacity_pages == 4
    keys = [bytes([i]) for i in range(5)]
    for h in keys[:4]:
        assert store.admit(h, {"page": h})
    assert store.bytes_resident == 400 and store.free_slots == 0
    # A chain lookup stops at the first miss and refreshes its hits.
    assert store.lookup_chain(keys[:3] + [b"missing"]) == keys[:3]
    assert store.admit(keys[4], {})                 # evicts keys[3], the LRU
    assert keys[3] not in store and keys[0] in store and store.evictions == 1
    store.take(keys[0])
    assert keys[0] not in store and store.promotions == 1
    assert store.discard(keys[1]) and not store.discard(keys[1])
    assert store.promotions == 1
    with pytest.raises(KeyError):
        store.take(keys[3])
    c = store.counters()
    assert c["demotions"] == 5.0 and c["hits"] == 3.0
    assert store.drain() == 2 and store.bytes_resident == 0


def test_host_store_zero_capacity_disables():
    store = HostPageStore(capacity_bytes=10, page_nbytes=100)
    assert not store.admit(b"h", {})
    assert store.bytes_resident == 0
    with pytest.raises(ValueError):
        HostPageStore(capacity_bytes=10, page_nbytes=0)


def test_prefix_evict_hook_sees_live_pages():
    """``on_evict`` fires before the entry's reference is dropped, so the
    page is still allocated when the hook copies it."""
    pool = PagePool(num_pages=8, page_size=4)
    prefix = PrefixCache(pool)
    seq = pool.allocate_sequence(12)
    prefix.insert([b"a", b"b", b"c"], seq.pages)
    pool.release(seq)
    seen = []
    freed = prefix.evict(2, on_evict=lambda h, pid: seen.append((h, pool.refcount(pid))))
    assert freed == 2 and seen == [(b"a", 1), (b"b", 1)]


# -- serving -------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_tiered_demote_promote_bit_match(models, kv_dtype):
    """Serve P, push its pages host-side with other requests, serve P
    again: the promoted pages give the untiered ids (and the JAX engine's)
    bit for bit, with demotions and promotions counted."""
    jparams, params = models
    rng = np.random.default_rng(0)
    p_shared = rng.integers(1, CFG.vocab, size=33)
    fillers = [rng.integers(1, CFG.vocab, size=40 + 8 * i) for i in range(3)]

    ref_eng = LLMEngine(CFG, params, kv_layout="paged", num_pages=96, page_size=8,
                        kv_dtype=kv_dtype, device="cpu")
    want = _greedy(ref_eng, [p_shared], 6)[0]
    ref_eng.close()
    assert want == _jax_greedy(jparams, [p_shared], 6, num_pages=96, kv_dtype=kv_dtype)[0]

    eng = LLMEngine(CFG, params, kv_layout="paged", num_pages=20, page_size=8,
                    host_pool_bytes=1 << 20, kv_dtype=kv_dtype, device="cpu")
    first = _greedy(eng, [p_shared], 6, uid0=0)[0]
    _greedy(eng, fillers, 4, uid0=100)
    st = eng.backend.prefix_stats()
    assert st["demoted_pages"] > 0 and st["host_entries"] > 0, st
    assert st["host_bytes_resident"] == st["host_entries"] * eng.backend.page_nbytes()
    again = _greedy(eng, [p_shared], 6, uid0=200)[0]
    st = eng.backend.prefix_stats()
    assert st["promoted_pages"] > 0, st
    assert first == want and again == want
    stats = eng.stats()
    assert stats.demoted_pages == int(st["demoted_pages"]) and stats.kv_dtype == kv_dtype
    assert "demoted" in stats.summary()
    eng.close()                                      # leak-free, or it raises
    assert eng.backend.host is not None and len(eng.backend.host) == 0


def test_tiered_payload_round_trip(models):
    """A demoted page's payload packs every layer's codes and scales into
    one byte buffer of the page's size, and restores them bit for bit into
    another page."""
    _, params = models
    eng = LLMEngine(CFG, params, kv_layout="paged", num_pages=16, page_size=8,
                    host_pool_bytes=1 << 20, kv_dtype="fp8", device="cpu")
    b = eng.backend

    def raw(t):
        return t.view(torch.uint8) if t.element_size() == 1 else t

    for pool in b.caches:
        for t in pool.values():                     # finite e4m3 bytes, positive scales
            raw(t).copy_(torch.randint(0, 120, t.shape, dtype=torch.uint8)
                         if t.element_size() == 1 else torch.rand(t.shape))
    payload = b._page_payload(3)
    assert payload.dtype == torch.uint8 and payload.numel() == b.page_nbytes()
    b._restore_page(payload, 5)
    for pool in b.caches:
        for t in pool.values():
            assert torch.equal(raw(t)[:, 5], raw(t)[:, 3])
    eng.close()


def test_tiered_preemption_resume_bit_match(models):
    """Preemption under decode pressure with the tier on: resumed sequences
    replay through promoted or recomputed prefixes and give the
    pressure-free engine's ids, which are the JAX engine's."""
    jparams, params = models
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, CFG.vocab, size=24) for _ in range(3)]

    big = LLMEngine(CFG, params, kv_layout="paged", num_pages=96, page_size=8, max_batch=3,
                    device="cpu")
    want = _greedy(big, prompts, 24)
    big.close()
    assert want == _jax_greedy(jparams, prompts, 24, num_pages=96, max_batch=3)

    small = LLMEngine(CFG, params, kv_layout="paged", num_pages=14, page_size=8, max_batch=3,
                      host_pool_bytes=1 << 20, device="cpu")
    got = _greedy(small, prompts, 24)
    assert small.backend.stats["preemptions"] > 0
    assert got == want
    small.close()


def test_host_pool_requires_prefix_sharing(models):
    _, params = models
    with pytest.raises(ValueError, match="prefix_sharing"):
        LLMEngine(CFG, params, kv_layout="paged", prefix_sharing=False,
                  host_pool_bytes=1 << 20, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        LLMEngine(CFG, params, kv_layout="dense", host_pool_bytes=1 << 20, device="cpu")
    eng = LLMEngine(CFG, params, host_pool_bytes=1 << 20, device="cpu")
    assert eng.kv_layout == "paged" and eng.backend.host.capacity_pages > 0
    eng.close()


def test_scheduler_stats_summary_includes_tier_line():
    s = SchedulerStats(kv_layout="paged", kv_dtype="int8", demoted_pages=7,
                       promoted_pages=3, host_bytes_resident=4096)
    text = s.summary()
    assert "int8" in text and "7 demoted" in text and "3 promoted" in text
    assert "tier" not in SchedulerStats().summary()
