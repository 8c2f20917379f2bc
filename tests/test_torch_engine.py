"""The port's ``LLMEngine(kv_layout="paged", device="cpu")`` against the JAX
package's ``repro.serving.LLMEngine(kv_layout="paged")`` on
``llama3_8b.SMOKE`` with the same weights: identical greedy token ids, with
prefix sharing and with preemption under a small pool."""

import time

import jax
import numpy as np
import pytest

from repro.configs import llama3_8b as jax_llama
from repro.models import transformer as jax_tf
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling

from repro_torch.cache.pool import SequenceReleasedError
from repro_torch.configs import llama3_8b
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request, SamplingParams


@pytest.fixture(scope="module")
def models():
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                         llama3_8b.SMOKE, device="cpu")
    return jparams, params


def _serve_both(models, prompts, engine_kw, req_kw):
    """Serve ``prompts`` on both engines; ``req_kw(i)`` gives request i's
    keyword arguments."""
    jparams, params = models
    jeng = JaxEngine(jax_llama.SMOKE, jparams, kv_layout="paged", **engine_kw)
    teng = LLMEngine(llama3_8b.SMOKE, params, kv_layout="paged", device="cpu", **engine_kw)
    jout = jeng.generate([JaxRequest(uid=i, prompt=p, **req_kw(i))
                          for i, p in enumerate(prompts)])
    tout = teng.generate([Request(uid=i, prompt=p, **req_kw(i))
                          for i, p in enumerate(prompts)])
    jtoks = {o.uid: [int(t) for t in o.tokens] for o in jout}
    ttoks = {o.uid: [int(t) for t in o.tokens] for o in tout}
    return jeng, teng, jtoks, ttoks, jout, tout


def test_greedy_ids_match_jax_with_prefix_sharing(models):
    rng = np.random.default_rng(3)
    system = rng.integers(1, 400, size=(32,))
    prompts = [np.concatenate([system, rng.integers(1, 400, size=(n,))]) for n in (5, 18, 2)]
    prompts.append(rng.integers(1, 400, size=(9,)))          # unshared
    kw = dict(num_pages=64, page_size=16, max_batch=3, max_pages_per_seq=8,
              prompt_buckets=(16, 32, 64))
    jeng, teng, jtoks, ttoks, _, _ = _serve_both(
        models, prompts, kw, lambda i: dict(max_new_tokens=6))
    assert ttoks == jtoks
    assert teng.backend.stats["pages_reused"] == jeng.backend.stats["pages_reused"] >= 4
    assert teng.backend.stats["extend_prefills"] >= 2
    assert teng.stats().prefix_hit_rate > 0
    # Sequence pages released; only prefix-cache pages remain in use.
    assert teng.backend.pool.used_pages == len(teng.backend.prefix)
    teng.close()
    assert teng.backend.pool.used_pages == 0


def test_greedy_ids_match_jax_under_preemption(models):
    """9 usable pages; each sequence grows to 4 pages (20 + 30 tokens): the
    pool preempts, resumes by replay, and still matches the JAX engine."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 400, size=(20,)) for _ in range(3)]
    kw = dict(num_pages=10, page_size=16, max_batch=3, max_pages_per_seq=4,
              prompt_buckets=(16, 32))
    jeng, teng, jtoks, ttoks, _, _ = _serve_both(
        models, prompts, kw, lambda i: dict(max_new_tokens=30, priority=i))
    assert ttoks == jtoks
    stats = teng.stats()
    assert stats.preemptions >= 1 and stats.resumed_tokens > 0
    assert teng.backend.check_leaks() == {}


def test_stop_tokens_and_streaming_match_jax(models):
    jparams, params = models
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 400, size=(12,))
    jeng = JaxEngine(jax_llama.SMOKE, jparams, kv_layout="paged", num_pages=32,
                     max_batch=2, prompt_buckets=(16,))
    free = jeng.generate([JaxRequest(uid=0, prompt=prompt, max_new_tokens=8)])[0]
    stop = int(free.tokens[3])
    jsp = JaxSampling(max_tokens=8, stop_token_ids=(stop,))
    tsp = SamplingParams(max_tokens=8, stop_token_ids=(stop,))
    jres = jeng.generate([JaxRequest(uid=1, prompt=prompt, sampling=jsp)])[0]
    teng = LLMEngine(llama3_8b.SMOKE, params, num_pages=32, max_batch=2,
                     prompt_buckets=(16,), device="cpu")
    teng.add_request(Request(uid=1, prompt=prompt, sampling=tsp))
    streamed, final = [], None
    while final is None:
        for o in teng.step():
            streamed += [int(t) for t in o.new_tokens]
            if o.finished:
                final = o
    assert [int(t) for t in final.tokens] == [int(t) for t in jres.tokens]
    assert final.finish_reason == jres.finish_reason == "stop"
    assert streamed == [int(t) for t in final.tokens]
    assert 1 in teng.ttft


def test_unported_options_raise(models):
    """``mesh`` and ``telemetry`` are not ported and raise; ``kv_dtype`` and
    ``host_pool_bytes`` are, and build a paged engine."""
    _, params = models
    cfg = llama3_8b.SMOKE
    for kw in (dict(mesh=2), dict(telemetry=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LLMEngine(cfg, params, device="cpu", **kw)
    for kw in (dict(kv_dtype="int8"), dict(host_pool_bytes=1 << 20)):
        eng = LLMEngine(cfg, params, device="cpu", **kw)
        assert eng.kv_layout == "paged"
        assert eng.stats().kv_dtype == kw.get("kv_dtype", "fp32")
        assert (eng.backend.host is not None) == ("host_pool_bytes" in kw)
        eng.close()


def test_engine_rejects_and_releases(models):
    _, params = models
    eng = LLMEngine(llama3_8b.SMOKE, params, num_pages=16, page_size=16, max_batch=2,
                    max_pages_per_seq=4, prompt_buckets=(16, 32), device="cpu")
    with pytest.raises(ValueError):              # outgrows max_pages_per_seq
        eng.add_request(Request(uid=0, prompt=np.ones(40, np.int64), max_new_tokens=40))
    with pytest.raises(SequenceReleasedError):
        eng.backend.release(0)
    with pytest.raises(ValueError):
        LLMEngine(llama3_8b.SMOKE, params, num_pages=4, max_pages_per_seq=8, device="cpu")


def test_reused_uid_gets_its_own_ttft(models):
    """Two ``generate`` calls on one engine that reuse uid 0: the second
    request's TTFT is measured from its own arrival, not kept from the
    first request's."""
    _, params = models
    eng = LLMEngine(llama3_8b.SMOKE, params, num_pages=32, page_size=16, max_batch=2,
                    max_pages_per_seq=4, prompt_buckets=(16, 32), device="cpu")
    rng = np.random.default_rng(9)
    eng.generate([Request(uid=0, prompt=rng.integers(1, 400, size=(20,)), max_new_tokens=3)])
    first = eng.ttft[0]
    t0 = time.perf_counter()
    eng.generate([Request(uid=0, prompt=rng.integers(1, 400, size=(7,)), max_new_tokens=3)])
    elapsed = time.perf_counter() - t0
    assert eng.ttft[0] != first
    assert 0.0 < eng.ttft[0] <= elapsed
    eng.close()
