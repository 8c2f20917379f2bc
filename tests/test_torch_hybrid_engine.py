"""The port's dense serving engine against the JAX package, on the CPU.

``LLMEngine(cfg, params)`` resolves ``kv_layout="auto"`` as the JAX engine
does (``tests/test_serving.py``): dense for the SSM and hybrid stacks the
paged pool cannot hold, paged for llama. Greedy token ids of hymba and
mamba2 SMOKE equal the JAX ``LLMEngine(kv_layout="dense")`` for prompts
whose length is a bucket, and the JAX package's unpadded prefill and decode
for prompts that are not (where the JAX engine's padded prefill leaks pad
tokens into the SSM state: ROADMAP Queue C). llama SMOKE served dense
equals the JAX dense engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hymba_1_5b as jax_hymba
from repro.configs import llama3_8b as jax_llama
from repro.configs import mamba2_1_3b as jax_mamba
from repro.models import transformer as jax_tf
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest

from repro_torch.configs import hymba_1_5b, llama3_8b, mamba2_1_3b
from repro_torch.models import transformer
from repro_torch.serving import LLMEngine, Request

CONFIGS = {"hymba": (jax_hymba.SMOKE, hymba_1_5b.SMOKE),
           "mamba2": (jax_mamba.SMOKE, mamba2_1_3b.SMOKE),
           "llama": (jax_llama.SMOKE, llama3_8b.SMOKE)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops gain nothing from intra-op threads, and under pytest-xdist
    those threads contend with the other workers' and stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (cfg_j, cfg) in CONFIGS.items():
        jparams = jax_tf.init_model(jax.random.PRNGKey(0), cfg_j)
        params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                             device="cpu")
        out[name] = (cfg_j, cfg, jparams, params)
    return out


def _jax_direct_greedy(cfg, params, prompt, n_new, cache_len=256):
    """The JAX package's unpadded prefill, then greedy decode steps."""
    lg, caches = jax_tf.prefill(params, cfg, jnp.asarray(prompt)[None], cache_len=cache_len)
    toks, lengths = [], jnp.array([len(prompt)], jnp.int32)
    nxt = int(jnp.argmax(lg[0]))
    for _ in range(n_new):
        toks.append(nxt)
        lengths = lengths + 1
        lg, caches = jax_tf.decode_step(params, cfg, jnp.asarray([nxt]), caches, lengths)
        nxt = int(jnp.argmax(lg[0]))
    return toks


def _serve(models, name, prompts, n_new, jax_engine: bool, kv_layout="auto", **kw):
    cfg_j, cfg, jparams, params = models[name]
    teng = LLMEngine(cfg, params, kv_layout=kv_layout, device="cpu", **kw)
    tout = teng.generate([Request(uid=i, prompt=p, max_new_tokens=n_new)
                          for i, p in enumerate(prompts)])
    ttoks = {o.uid: [int(t) for t in o.tokens] for o in tout}
    assert all(o.finish_reason == "length" for o in tout)
    jtoks = None
    if jax_engine:
        jeng = JaxEngine(cfg_j, jparams, kv_layout="dense", **kw)
        jout = jeng.generate([JaxRequest(uid=i, prompt=p, max_new_tokens=n_new)
                              for i, p in enumerate(prompts)])
        jtoks = {o.uid: [int(t) for t in o.tokens] for o in jout}
    return teng, ttoks, jtoks


@pytest.mark.parametrize("name", ["hymba", "mamba2"])
def test_bucket_length_prompts_match_the_jax_dense_engine(models, name):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 500, size=(n,)) for n in (32, 64, 32, 64)]
    teng, ttoks, jtoks = _serve(models, name, prompts, 6, True, max_batch=3, cache_len=128,
                                prompt_buckets=(32, 64))
    assert teng.kv_layout == "dense"
    assert ttoks == jtoks


@pytest.mark.parametrize("name", ["hymba", "mamba2"])
def test_padded_prompts_match_the_jax_unpadded_path(models, name):
    """Prompts off the buckets (one shorter than the conv history is
    excluded: the JAX package's unpadded prefill cannot take it)."""
    cfg_j, _, jparams, _ = models[name]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 500, size=(n,)) for n in (20, 45, 9, 33, 70)]
    teng, ttoks, _ = _serve(models, name, prompts, 6, False, max_batch=2, cache_len=128,
                            prompt_buckets=(32, 64, 96))
    for i, p in enumerate(prompts):
        assert ttoks[i] == _jax_direct_greedy(cfg_j, jparams, p, 6), i
    stats = teng.stats()
    assert stats.kv_layout == "dense" and stats.prefix_hit_rate is None
    assert "prefix hit n/a" in stats.summary()
    assert stats.prefill_launches == len(prompts) and stats.completed == len(prompts)
    teng.close()
    assert not teng.backend.active.any()


def test_llama_dense_engine_matches_the_jax_dense_engine(models):
    """As ``tests/test_serving.py::test_continuous_batching_matches_direct``:
    three slots, five prompts off and on the buckets, slots reused."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 400, size=(n,)) for n in (8, 20, 33, 11, 40)]
    teng, ttoks, jtoks = _serve(models, "llama", prompts, 5, True, kv_layout="dense",
                                max_batch=3, cache_len=256, prompt_buckets=(32, 64))
    assert teng.kv_layout == "dense"
    assert ttoks == jtoks


def test_kv_layout_auto_resolves_as_the_jax_engine(models):
    """As ``tests/test_serving.py::test_kv_layout_auto_resolves_through_plan_layer``."""
    _, lcfg, _, lparams = models["llama"]
    eng = LLMEngine(lcfg, lparams, max_batch=2, num_pages=32, page_size=16,
                    max_pages_per_seq=4, prompt_buckets=(16, 32), device="cpu")
    assert eng.kv_layout == "paged"
    assert LLMEngine(lcfg, lparams, device="cpu").kv_layout == "paged"
    for name in ("hymba", "mamba2"):
        _, cfg, _, params = models[name]
        assert LLMEngine(cfg, params, device="cpu").kv_layout == "dense"
        with pytest.raises(ValueError, match="pure self-attention"):
            LLMEngine(cfg, params, kv_layout="paged", device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        LLMEngine(lcfg, lparams, kv_layout="sparse", device="cpu")


def test_dense_engine_rejects_what_its_stripes_cannot_hold(models):
    _, cfg, _, params = models["hymba"]
    eng = LLMEngine(cfg, params, max_batch=2, cache_len=64, prompt_buckets=(32, 64),
                    device="cpu")
    with pytest.raises(ValueError, match="buckets"):
        eng.add_request(Request(uid=0, prompt=np.ones(70, np.int64), max_new_tokens=1))
    with pytest.raises(ValueError, match="stripe"):
        eng.add_request(Request(uid=1, prompt=np.ones(40, np.int64), max_new_tokens=30))
    with pytest.raises(ValueError, match="resume"):
        eng.backend.try_admit(Request(uid=2, prompt=np.ones(8, np.int64)), resume_tokens=[1])


def test_dense_backend_reports_no_prefix_cache_and_models_its_tick(models):
    """As the JAX ``DenseBackend``: a structural-zero prefix record with
    ``prefix_hit_rate`` None, and a tick time that charges the whole stripe
    whatever is live."""
    from repro_torch.core import numa, perf_model

    _, cfg, _, params = models["hymba"]
    backend = LLMEngine(cfg, params, max_batch=2, cache_len=64, prompt_buckets=(32,),
                        device="cpu").backend
    stats = backend.prefix_stats()
    assert stats["prefix_hit_rate"] is None and stats["pages_reused"] == 0.0
    want = perf_model.estimate_dense_decode(
        batch=4, num_q_heads=cfg.n_heads, num_kv_heads=cfg.n_kv_heads, capacity=64,
        head_dim=cfg.head_dim, dtype_bytes=4, topo=numa.H100).time
    assert backend.decode_time_model(4) == backend.decode_time_model(4, mean_len=3.0) == want


def test_a_decode_tick_over_a_free_slot_leaves_the_live_rows_exact(models):
    """Slot 0 finishes first; the tick then runs slots 0..1 with slot 0 free
    (length 0): slot 1's tokens equal serving it alone."""
    _, cfg, _, params = models["hymba"]
    rng = np.random.default_rng(3)
    short, long = rng.integers(1, 500, size=(12,)), rng.integers(1, 500, size=(30,))
    kw = dict(max_batch=2, cache_len=128, prompt_buckets=(32,), device="cpu")
    eng = LLMEngine(cfg, params, **kw)
    out = eng.generate([Request(uid=0, prompt=short, max_new_tokens=2),
                        Request(uid=1, prompt=long, max_new_tokens=9)])
    both = {o.uid: [int(t) for t in o.tokens] for o in out}
    alone = LLMEngine(cfg, params, **kw).generate([Request(uid=1, prompt=long,
                                                           max_new_tokens=9)])
    assert both[1] == [int(t) for t in alone[0].tokens]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-1.3b"])
def test_serve_launcher_runs_dense_on_cpu(capsys, arch):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-new-tokens", "4", "--prompt-len", "20"])
    out = capsys.readouterr().out
    assert "kv_layout=dense device=cpu" in out
    assert out.count("finish=length") == 3 and "3 done" in out
